"""Host data side of the port: PNG and JPEG read and PNG write, the
datasets and their wrappers, the train stages (InstaBoost, albu), the
train and test pipelines, the loader, scene tiling and merge, and the
DOTA merge helpers.  Importing this package imports no torch (the
merge's spawned workers import `tiling` through it)."""
