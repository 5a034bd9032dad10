"""Selectable config, a copy of the reference's: see archs.py for the
exact published spec."""
from .archs import QWEN3_32B as CONFIG
from .base import reduced, shapes_for

SMOKE = reduced(CONFIG)
SHAPES = shapes_for(CONFIG)
