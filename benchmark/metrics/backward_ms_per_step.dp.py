"""training step: ``backward_ms_per_step.train``'s reading in the dp cells (rank 0's traced
steps), which report ``train_step_ms.dp``."""
import harness

UNIT, read = harness.twin("backward_ms_per_step.train", "dp")
