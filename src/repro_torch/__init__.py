"""PyTorch/CUDA port of the ``repro`` serving system.

The package mirrors the reference package's module layout
(``repro_torch/serve/engine.py`` is the counterpart of
``repro/serve/engine.py``) and imports only ``torch``, ``numpy`` and
itself.  Entry points run on the CUDA device unless the caller asks for
the CPU (``device="cpu"``); a request for the card on a machine without
one raises instead of falling back.  Hand-written kernels live under
``kernels/`` beside their plain-PyTorch twins.
"""
