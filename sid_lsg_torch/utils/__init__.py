"""Host-side helpers of the port: run dirs, log tee, stat counters."""
