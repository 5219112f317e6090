"""device, whole step: ``mfu.train``'s reading in the dp cells (rank 0's traced
steps), which report ``train_step_ms.dp``."""
import harness

UNIT, read = harness.twin("mfu.train", "dp")
