"""Validate a GGUF file: header, metadata, tensor table, payload sizes (port
of the JAX package's tools/validate_gguf.py, over the port's io/gguf.py).

The role of streaming-sortformer/scripts/validate_gguf.py: check a
converted model before the runtime loads it.

    python -m open_whisper_kit_tpu_torch.tools.validate_gguf model.gguf [--stats]

--stats also decodes every tensor and reports NaN / Inf counts (slow for
big files). Exit code 0 when the file is sound, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--max-print", type=int, default=12)
    args = ap.parse_args(argv)

    from ..io import gguf as G
    from ..io import quant as Q

    try:
        f = G.load_gguf(args.path)
    except Exception as e:  # noqa: BLE001
        print(f"FAIL: cannot parse GGUF: {e}", file=sys.stderr)
        return 1

    print(f"version      : {f.version}")
    print(f"metadata keys: {len(f.metadata)}")
    for k in list(f.metadata)[:args.max_print]:
        s = repr(f.metadata[k])
        print(f"  {k} = {s[:80] + '...' if len(s) > 80 else s}")
    print(f"tensors      : {len(f.tensors)}")

    bad = 0
    types = Counter()
    for t in f.tensors.values():
        types[Q.type_name(t.ggml_type)] += 1
        n = int(np.prod(t.shape)) if t.shape else 1
        try:
            expect = Q.nbytes_for(t.ggml_type, n)
        except Exception:  # non-divisible or unknown type
            print(f"  BAD  {t.name}: type {t.ggml_type} x {t.shape}")
            bad += 1
            continue
        if t.data is not None and len(t.data) != expect:
            print(f"  BAD  {t.name}: {len(t.data)} bytes, expected {expect}")
            bad += 1
    print(f"dtype counts : {dict(types)}")

    if args.stats:
        worst_nan = 0
        for name in f.tensors:
            try:
                a = np.asarray(f.to_float(name), np.float32)
            except Exception:  # noqa: BLE001
                continue
            n_nan = int(np.isnan(a).sum())
            n_inf = int(np.isinf(a).sum())
            if n_nan or n_inf:
                print(f"  NAN  {name}: {n_nan} NaN / {n_inf} Inf")
                worst_nan += n_nan + n_inf
        print(f"nan/inf total: {worst_nan}")
        bad += 1 if worst_nan else 0

    print("OK" if bad == 0 else f"FAIL ({bad} problems)")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
