"""The benchmark's plain reference: CIM's model, mining, losses, SGD step
and 10-pass TTA evaluation in plain PyTorch and NumPy.

Nothing here imports the program under test (``cim_tpu_torch``), JAX or
``cim_tpu``. The modules are frozen copies of the published semantics
(the reference implementation's heads, mining and losses, as the port
states them), written for clarity and not speed: no padding, no buckets,
no kernels, float32 with TF32 off. The harness hands them the same
weights and inputs it hands the program; whatever the program derives
from those (buckets, padding, pseudo labels) is worked out again here.
"""
