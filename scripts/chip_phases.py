"""Phases of chip_smoke.py alone, on the card: the kernels built, then
the phases named on the command line (all of them by default):

  16     phase 16's one-card part (``phase_mesh``)
  17     phase 17 (``phase_dryrun``)
  16x4   phase 16's four-card part (``phase_mesh4``: EP, DP, TP+FSDP,
         the sequence-sharded decode)
  16x4tp only its tensor-parallel FSDP part (``spawn_tp``)
  16x4seq only its sequence-sharded decode (``spawn_seq``)

  python3 scripts/chip_phases.py 16 17
"""
import subprocess
import sys
import time
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if __name__ == "__main__":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    C.log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.library()
    C.log(f"build {_build.build_info['seconds']:.1f} s")
    dev = C.card()
    parts = sys.argv[1:] or ["16", "17", "16x4"]
    if "16" in parts:
        t = time.perf_counter()
        C.phase_mesh(0, dev)
        C.log(f"phase16 one-card part {time.perf_counter() - t:.1f} s")
    if "17" in parts:
        t = time.perf_counter()
        C.phase_dryrun(0, dev, smi)
        C.log(f"phase17 {time.perf_counter() - t:.1f} s")
    if "16x4" in parts:
        t = time.perf_counter()
        rows = C.phase_mesh4(0)
        C.log(f"phase16 four-card part {time.perf_counter() - t:.1f} s")
        import json
        print(json.dumps({"rows": rows}), flush=True)
    if "16x4seq" in parts:
        import json
        res, t = C.timed(lambda: C.spawn_seq(0))
        C.log(f"phase16 seq: {json.dumps(res)}; spawn to end "
              f"wall_s={t:.1f}")
    if "16x4tp" in parts:
        import json
        res, t = C.timed(lambda: C.spawn_tp(0))
        C.log(f"phase16 tp: {json.dumps(res)}; spawn to end "
              f"wall_s={t:.1f}")
