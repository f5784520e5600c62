"""The port imports without JAX, as on the GPU machine, which has neither
JAX nor the JAX package, nor transformers or pyyaml.

A child process installs a `sys.meta_path` finder that refuses `jax`,
`jaxlib`, `open_whisper_kit_tpu` (not `open_whisper_kit_tpu_torch`),
`transformers` and `yaml`, then imports every module of
open_whisper_kit_tpu_torch (the tools included) and chip_smoke.py's top
level. The tools that need transformers or pyyaml import them only when
they convert.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "open_whisper_kit_tpu", "transformers", "yaml")

CHILD = r"""
import importlib, importlib.util, json, pkgutil, sys
REFUSED = set(json.loads(sys.argv[1]))

def refused(name):
    return name.split(".")[0] in REFUSED

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ModuleNotFoundError(f"No module named {name!r} (refused)", name=name)
        return None

for name in [m for m in sys.modules if refused(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])

import open_whisper_kit_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
failed = {}
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:
        failed[name] = f"{type(e).__name__}: {e}"
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2] + "/chip_smoke.py")
try:
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
except Exception as e:
    failed["chip_smoke.py"] = f"{type(e).__name__}: {e}"
print(json.dumps({"names": names, "failed": failed,
                  "loaded": sorted(m for m in sys.modules if refused(m))}))
"""


def test_the_port_imports_with_jax_refused():
    out = subprocess.run([sys.executable, "-c", CHILD, json.dumps(REFUSED), str(REPO)],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["failed"] == {} and got["loaded"] == []
    names = set(got["names"])
    modules = set()
    for p in (REPO / "open_whisper_kit_tpu_torch").rglob("*.py"):
        parts = p.relative_to(REPO).with_suffix("").parts
        modules.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert modules <= names, sorted(modules - names)
    assert {f"open_whisper_kit_tpu_torch.tools.{t}" for t in (
        "english_normalizer", "eval_wer", "convert_pt_to_ggml", "convert_hf_to_ggml",
        "convert_nemo_to_gguf", "validate_gguf", "compare_rttm")} <= names
