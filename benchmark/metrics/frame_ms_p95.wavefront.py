"""frame_ms_p95 where it is a per-layer metric (the wavefront cells):
the same 95th percentile of every frame's completion interval, read
from the untraced window of the --trace 1 run. There the frame tail
follows the host that issues the wavefront's launches."""

from benchmark import cells

read = cells.reader("frame_ms_p95")
