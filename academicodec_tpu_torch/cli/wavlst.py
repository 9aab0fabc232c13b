"""Filelist generator (reference: egs/util/wavlstgen.py); the port's copy of
``academicodec_tpu/cli/wavlst.py``.

    python -m academicodec_tpu_torch.cli.wavlst --wavdir wavs/ --outfile train.lst
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser("wavlst")
    p.add_argument("--wavdir", type=str, required=True)
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--ext", type=str, default=".wav")
    args = p.parse_args(argv)

    count = 0
    with open(args.outfile, "w") as out:
        for root, _dirs, files in os.walk(args.wavdir):
            for f in sorted(files):
                if f.endswith(args.ext):
                    out.write(os.path.join(root, f) + "\n")
                    count += 1
    print(f"wrote {count} paths to {args.outfile}")


if __name__ == "__main__":
    main()
