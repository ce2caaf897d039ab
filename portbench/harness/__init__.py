"""What every cell shares: the manifest, inputs from the seed, tracing, bounds, comparisons."""
