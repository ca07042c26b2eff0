"""PyTorch/CUDA port of ``repro``, grown slice by slice beside the JAX package.

The port imports ``torch`` and never ``jax`` or anything of ``repro``: what it
needs from there is copied.  Its layout and names follow ``repro`` so each
counterpart is easy to find.  Entry points run on the CUDA card unless the
caller asks for the CPU (``device="cpu"``, ``--device cpu``), which is what the
tests do; see :func:`repro_torch.device.resolve_device`.
"""
