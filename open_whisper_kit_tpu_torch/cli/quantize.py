"""quantize: ggml-bin requantizer CLI (examples/quantize/quantize.cpp);
port of open_whisper_kit_tpu/cli/quantize.py over the port's ggml writer
(host only, byte-identical output).

Usage: python -m open_whisper_kit_tpu_torch.cli.quantize model-f32.bin model-q5_0.bin q5_0
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("usage: quantize model-f32.bin model-quant.bin type\n"
              "  type: f16, q4_0, q4_1, q5_0, q5_1, q8_0, "
              "q2_k, q3_k, q4_k, q5_k, q6_k", file=sys.stderr)
        return 1
    src, dst, type_name = argv
    from ..io.ggml_writer import TYPE_FOR_NAME, requantize
    if type_name not in TYPE_FOR_NAME:
        print(f"error: unknown type {type_name}", file=sys.stderr)
        return 1
    requantize(src, dst, type_name)
    print(f"wrote {dst} ({type_name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
