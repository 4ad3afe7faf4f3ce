"""The analysis tools and the examples' checkers on the port.

Each module is the twin of the tool of the same name in the repo's
``tools/`` (the same functions, command line and output files) and runs
as ``python -m mpgadget_tpu_torch.tools.<name>``; ``check_examples``
holds the checks of the four ``examples/*/check_results.py``.  They
import torch, numpy and the port, never JAX.  A tool that computes on
arrays does so on the card unless asked for the CPU (``--device cpu``);
with no card it refuses rather than fall back.
"""


def torch_device(name):
    """The torch device a tool computes on: ``name`` ("cuda" or "cpu").
    Raises SystemExit for a CUDA device when no card is found."""
    import torch
    if name != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available (pass "
                         "--device cpu to compute on the CPU)")
    return torch.device(name)
