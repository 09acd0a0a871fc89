"""Shared plumbing: EDict, bucketing, frame index, telemetry."""
