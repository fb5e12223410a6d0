#!/usr/bin/env python
"""Write the synthetic test split's reference wavs (the targets that
``autoencode_torch.py predict`` resynthesizes as item%04d.wav) for
PESQ/FAD, with the port's data modules (counterpart of
``tools/dump_refs.py``; host only, the same files bit for bit).

Usage:
    python tools/dump_refs_torch.py <config.yaml> <out_dir>
"""
import pathlib
import sys

import numpy as np
import yaml

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    cfg_path, out_dir = (sys.argv[1:] if argv is None else argv)[:2]
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    from golf_tpu_torch.config.registry import instantiate
    from golf_tpu_torch.utils.wav import write_wav
    dm = instantiate(cfg["data"])
    dm.setup("predict")
    sr = cfg.get("model", {}).get("init_args", {}).get("sample_rate", 24000)
    for i in range(len(dm.predict_dataset)):
        x, f0, rel = dm.predict_dataset[i]
        write_wav(str(pathlib.Path(out_dir) / rel), np.asarray(x), sr)
    print(f"wrote {len(dm.predict_dataset)} refs to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
