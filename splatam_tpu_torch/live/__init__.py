"""The live NeRFCapture (iPhone) stream: the DDS bridge (dds.py) and
samples served from frames in memory (replay.py).

Counterpart of splatam_tpu/live.
"""
