"""Host data side of the port: scene tiling and merge, the DOTA merge
helpers and the test pipeline.  Importing this package imports no
torch (the merge's spawned workers import `tiling` through it)."""
