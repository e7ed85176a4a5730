"""Example runs of the port, one module each with ``run(quick=False,
device=None)`` and a ``--quick`` command line
(``python -m ins_tpu_torch.examples.<name> [--quick] [--device cpu]``).
"""
