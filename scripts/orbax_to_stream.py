"""Convert an orbax checkpoint directory of the JAX package to the stream
format, which the PyTorch port reads without JAX.

    python scripts/orbax_to_stream.py <orbax_dir> <out.ckpt>

The JAX package's ``ckpt_io.load`` restores the orbax tree (its fallback
for checkpoints written before the stream format) and ``ckpt_io.save_stream``
writes it leaf by leaf. The port then resumes or evaluates from
``out.ckpt`` (``aid_tpu_torch.utils.checkpoint.load``); name it
``{exp_name}-{it}.ckpt`` inside a model directory for the latest-checkpoint
scans. This script runs on the JAX side: it imports ``aid_tpu`` and never
``aid_tpu_torch``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def convert(src: str, dst: str) -> str:
    """Load ``src`` (orbax or stream) and write it as a stream checkpoint
    at ``dst``; returns ``dst``."""
    from aid_tpu.utils import ckpt_io
    if os.path.abspath(src) == os.path.abspath(dst):
        raise ValueError("write the stream checkpoint to another path than its source")
    return ckpt_io.save_stream(dst, ckpt_io.load(src))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python scripts/orbax_to_stream.py <orbax_dir> <out.ckpt>",
              file=sys.stderr)
        return 2
    import jax
    # a conversion needs no accelerator: keep JAX on the host
    jax.config.update("jax_platforms", "cpu")
    print(f"wrote {convert(argv[0], argv[1])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
