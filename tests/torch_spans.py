"""The port's span forest held to the JAX package's, on the reference's spans.

The port traces more than the reference: stage spans inside ``lap.solve``,
``pack`` and ``migrate.host``, and the simulator's own.  :func:`project`
keeps the spans whose names the reference's run emitted, hoists the
children of every other span into its place, in order, and drops ``seq``
(the list order keeps the sequence).  So every reference span's name,
nesting, attributes, order and ``tid`` are still compared, and a span the
reference emits that the port lacks, or one it emits in another place, fails
the comparison.
"""

from typing import Dict, Iterable, List, Set


def span_names(forest: Iterable[Dict]) -> Set[str]:
    """Every span name in a ``Tracer.structure()`` forest."""
    names: Set[str] = set()
    for d in forest:
        names.add(d["name"])
        names |= span_names(d.get("children", ()))
    return names


def project(forest: Iterable[Dict], names: Set[str]) -> List[Dict]:
    """The forest restricted to spans named in ``names``: others are
    dropped and their children hoisted in order; ``seq`` is dropped."""
    out: List[Dict] = []
    for d in forest:
        kids = project(d.get("children", ()), names)
        if d["name"] not in names:
            out.extend(kids)
            continue
        e = {k: v for k, v in d.items() if k not in ("seq", "children")}
        if kids:
            e["children"] = kids
        out.append(e)
    return out


def assert_reference_spans_equal(ref: List[Dict], port: List[Dict], names=None) -> None:
    """The port's forest, projected onto the reference's span names (those
    of ``ref`` unless ``names`` is given), equals the reference's."""
    names = span_names(ref) if names is None else names
    assert names, "the reference emitted no span"
    assert project(port, names) == project(ref, names)
