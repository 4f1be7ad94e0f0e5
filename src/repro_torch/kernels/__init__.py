"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

=====================  ===============================  ==========================
kernel (csrc/)         wrapper                          replaces (JAX/Pallas)
=====================  ===============================  ==========================
``lap_bid.cu``         :func:`lap_bid.lap_bid_batched`  ``lap_bid_pallas``,
                                                        ``lap_bid_pallas_batched``
``lap_bid.cu``         :func:`lap_bid.                  ``lap_bid_fused_pallas``,
(``kFused``)           lap_bid_fused_batched`           ``lap_bid_fused_pallas_batched``
``migration_cost.cu``  :func:`migration_cost.           ``migration_cost_pallas``
                       migration_cost`
``flash_attention.cu`` :func:`flash_attention.          ``flash_attention_pallas``
                       flash_attention`
``flash_decode.cu``    :func:`flash_decode.             ``flash_decode_pallas``
                       flash_decode`
=====================  ===============================  ==========================

Wrappers launch the kernel for CUDA tensors (building every kernel with
``nvcc`` on first use, see :mod:`repro_torch.kernels.build`) and use the
plain version only for CPU tensors.  Each wrapper counts its launches in a
``launches`` attribute.
"""
