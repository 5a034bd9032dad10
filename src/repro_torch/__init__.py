"""PyTorch/CUDA port of the MARLaaS reproduction (``repro``), for one NVIDIA
H100.

The module layout mirrors ``repro`` so that each counterpart is found by path.
The port imports ``torch`` and numpy only: never ``jax`` and no module of
``repro``. Entry points take an explicit ``device`` (default ``"cuda"``); the
CPU runs only when a caller asks for it, and then every kernel wrapper takes
its plain PyTorch version.
"""
