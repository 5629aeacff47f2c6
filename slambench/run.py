"""Entry point of the benchmark: ``python3 slambench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout (see
``harness.py``)."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Load from one process with few threads; the caches of any kernel
# compiler at fixed paths inside the checkout (the port's own library is
# built under build/kernels/ by its _build.py).
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))

from slambench.harness import main, process_start_wall  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_proc=process_start_wall()))
