"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
scheduling round of Tesserae after another on the card, at cluster sizes
users deploy, judged against a plain reference.  ``run.py`` is the entry."""
