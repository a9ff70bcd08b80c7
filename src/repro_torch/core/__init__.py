"""Host-side helpers of the port: metrics, profiler records, transport models."""
