"""The benchmark of ``tracknetv3_tpu_torch``: discovery of cells by name,
the frozen synthetic inputs, traffic generators, host spans, the device
trace, roofline arithmetic and the runners that run a cell."""
