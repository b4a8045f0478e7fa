"""Time the port's flash-decoding kernel (K2) of one source tree, on a card.

    python scripts/torch_k2_times.py [SRC]

``SRC`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so two trees can be compared in one run on one
card: the parent's and the change's, in turns (parent, change, change,
parent). The shapes are ``chip_smoke.py``'s: internlm2-1.8b's decode
(4 slots, max_len 1024, 16 q / 8 kv heads of 128) and glm4-9b's (32 q / 2
kv heads), an f32 cache and a bf16 q, at the serve path's lengths
(DEC_PATH_LENS) and uniform fills of 64 and 1024 rows. Each time is
``chip_smoke.cuda_ms``'s median over seven rounds of 30 launches, with
the cache flushed from L2 before each launch, unspun (``ms``) and with
the card spun before each start event (``device_ms``). Prints the card's
name and power limit, then one JSON line.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    rows = []
    for arch, hq, hkv in (("internlm2-1.8b", 16, 8), ("glm4-9b", 32, 2)):
        q = torch.randn((4, 1, hq, 128), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((4, 1024, hkv, 128), generator=gen, device=dev) for _ in range(2))
        for lens in (cs.DEC_PATH_LENS, (64,) * 4, (1024,) * 4):
            clen = torch.tensor(lens, dtype=torch.int32, device=dev)

            def fn():
                return decode_attention_kernel(q, kc, vc, clen)
            fn()
            ms = [cs.cuda_ms(fn, iters=30, flush=flush) for _ in range(7)]
            spun = [cs.cuda_ms(fn, iters=30, flush=flush, spin=True) for _ in range(7)]
            rows.append(dict(arch=arch, lens=list(lens), ms=float(np.median(ms)),
                             device_ms=float(np.median(spun))))
    print(json.dumps({"src": str(src), "device": torch.cuda.get_device_name(0), "k2": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
