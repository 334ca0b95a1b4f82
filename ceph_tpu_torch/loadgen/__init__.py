"""Load-harness statistics (port of the part of ceph_tpu/loadgen that the
tracer and the op tracker use: `stats.LatencyHistogram`,
`stats.GoodputMeter`)."""
