"""a-Tucker on PyTorch and CUDA: the port of the JAX package ``repro``.

Same layout and module names as ``repro``; imports neither jax nor
``repro``.  ``repro_torch.core`` is the plan/execute front door,
``repro_torch.kernels`` the hand-written Hopper kernels behind the
``hopper`` ops backend.  ``models``, ``serve`` and ``launch.serve`` serve
falcon-mamba-7b; ``optim``, ``data``, ``train``, ``checkpoint`` and
``launch.train`` train it (with the Tucker gradient compressor and the
Tucker checkpoint codec).
"""
