"""kernel: ``fused_adaln_roofline.train``'s reading in the dp cells (rank 0's traced
steps), which report ``train_step_ms.dp``."""
import harness

UNIT, read = harness.twin("fused_adaln_roofline.train", "dp")
