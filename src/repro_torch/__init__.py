"""repro_torch — the MG3M convolution stack in PyTorch with hand-written
CUDA kernels for Hopper (a port of the JAX/Pallas package ``repro``, which
stays the reference).

Layouts follow the reference at every public function: IN ``[H, W, C, B]``,
FLT ``[fltH, fltW, IC, OC]``, OUT ``[outH, outW, OC, B]``.  Entry points run
on the card unless given ``device="cpu"``.
"""
