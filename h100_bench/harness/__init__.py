"""The benchmark harness: cell discovery, inputs, traces, rooflines and readouts."""
