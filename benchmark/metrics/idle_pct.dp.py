"""device: ``idle_pct.train``'s reading in the dp cells (rank 0's traced
steps), which report ``train_step_ms.dp``."""
import harness

UNIT, read = harness.twin("idle_pct.train", "dp")
