"""The benchmark's general code: cells found by name, weights and traffic
made from the seed, the timed window, the trace reduction and the judge."""
