"""Host I/O (counterpart of hectorgrapher_tpu/io/): the npz checkpoint and
the reference's pbstream format, recorded-data readers (PLY, PCD, xyz, the
sensor CSVs, ROS bags), the points pipeline, map painting and PNG output."""
