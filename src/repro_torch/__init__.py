"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``core``, ``data``, ``models``,
``kernels``) so each module's counterpart is found by its path. The gossip
mix, the step that carries D-PSGD on the device, runs in hand-written CUDA
kernels (``csrc/gossip_mix.cu``) for tensors on an sm_90 card and in their
plain torch versions for tensors on the CPU. The package imports neither
``jax`` nor ``repro``; numpy-only modules it needs are copied.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
