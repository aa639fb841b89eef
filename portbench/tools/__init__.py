"""Tools for setting the benchmark's limits and bounds; the benchmark's
own runs do not use them."""
