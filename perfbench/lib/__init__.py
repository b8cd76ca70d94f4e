"""The harness's yardstick: traffic, weights, traces, work counts."""
