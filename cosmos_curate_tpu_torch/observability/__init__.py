"""The observability layer (port of ``cosmos_curate_tpu/observability/``):
spans, stage_timer's aggregates, the live status and its anomaly detector,
artifact delivery and the flight recorder. Host code only: no module here
imports torch, and nothing here synchronises the device."""
