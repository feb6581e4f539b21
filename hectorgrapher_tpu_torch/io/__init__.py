"""State I/O: the npz checkpoint and the reference's pbstream format
(counterpart of hectorgrapher_tpu/io/)."""
