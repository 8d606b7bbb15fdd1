"""Data-parallel and multi-host training and serving (the JAX package's
``parallel/``): ``mesh`` holds the world of ranks and its collectives,
``multihost`` the multi-process initialization."""
