"""Host data side of the port: PNG read and write, the datasets, the
train and test pipelines, the loader, scene tiling and merge, and the
DOTA merge helpers.  Importing this package imports no torch (the
merge's spawned workers import `tiling` through it)."""
