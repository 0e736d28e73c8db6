"""Training: AdamW with its schedule, clipping and fp32 masters
(``train/optimizer.py``), and the microbatched train step
(``train/loop.py``). Mirrors ``repro.train``."""
