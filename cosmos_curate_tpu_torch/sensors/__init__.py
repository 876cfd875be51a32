"""Sensor rigs (port of ``cosmos_curate_tpu/sensors/``): host code, numpy,
cv2 and ``zstandard``; imports no torch."""
