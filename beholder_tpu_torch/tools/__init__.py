"""Operator and measurement tools of the port: the step-level serving
profile (:mod:`.profile_serving`) and the telemetry producer CLI
(:mod:`.publish`)."""
