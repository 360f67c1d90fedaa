"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``configs``, ``core``, ``data``,
``models``, ``kernels``, ``launch``) so each module's counterpart is found
by its path. Two paths run on the card: the paper's D-PSGD run, whose
gossip mix is a hand-written CUDA kernel (``csrc/gossip_mix.cu``), and
serving the model zoo (``launch.serve``: the decoder-only archs, MLA and
MoE, and the encoder-decoder), whose prefill attention
(``csrc/flash_attention.cu``) and RG-LRU recurrence
(``csrc/rglru_scan.cu``) are hand-written CUDA kernels. Each kernel runs
for tensors on an sm_90 card and its plain torch version for tensors on
the CPU. The package imports neither ``jax`` nor ``repro``; the modules it
needs from the JAX package that import no jax (the numpy planes, the
configs) are copied.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
