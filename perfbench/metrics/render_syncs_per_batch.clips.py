"""``render_syncs_per_batch.gen``'s reading, in cells where ``frames_per_s`` is not an
end-to-end metric, so that the layer moves ``batch_ms_p95``."""

from harness.manifest import reader

read = reader("render_syncs_per_batch.gen")
