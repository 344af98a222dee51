"""The harness of the port's benchmark: what every cell shares.

``spec`` finds a cell's configuration, traffic, limits, driver and metric
readers by name; ``env`` pins the caches and checks the loaded modules;
``trace`` reduces a ``torch.profiler`` trace; ``peaks`` and ``work`` are the
yardstick (the card's published peaks, and operations and bytes counted
from shapes); ``graphs`` makes the input graphs from seeds.  Nothing here
imports the program: drivers do, and only they.
"""
