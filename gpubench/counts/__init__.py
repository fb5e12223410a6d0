"""The yardstick: the card's published peaks, the bytes each kernel's
operation needs and the model FLOPs of a step, all from shapes."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
