"""Row-band rendering: one image split into bands of rows (spatial.py)."""
