"""xna_basecaller_tpu_torch: the XNA basecaller in PyTorch, with CUDA
kernels written for NVIDIA Hopper (sm_90a).

A port of ``xna_basecaller_tpu`` (JAX/Pallas), which stays the reference
it is tested against.  This package imports ``torch`` and never ``jax``,
nor anything of ``xna_basecaller_tpu``: the pure-numpy host modules it
needs are copies.  Public entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""
