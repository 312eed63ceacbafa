"""Telemetry of the port: the no-op recorder surface for now."""
