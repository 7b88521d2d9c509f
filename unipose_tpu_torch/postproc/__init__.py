"""Multi-person decoding for the box-head model and detection NMS."""
