"""Command-line entry point of the port (python -m zeronotesamba_torch).

Subcommands:
    infer        one file -> pulse + beats (JSON on stdout)

The JAX package's other subcommands are not ported yet (ROADMAP "Modules to
port", item 11).
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("zeronotesamba_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    i = sub.add_parser("infer", help="track one audio file")
    i.add_argument("audio", help="wav file")
    i.add_argument("--params", default=None, help="state dict (.pth or .npz) in the reference key names")
    i.add_argument("--separation", default="hpss", choices=["hpss", "stems", "mix"])
    i.add_argument("--decoder", default="dbn", choices=["dbn", "threshold"])
    i.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    i.add_argument("--out", default=None, help="write JSON result here")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.cmd == "infer":
        from zeronotesamba_torch.infer import BeatTracker
        from zeronotesamba_torch.models.weights import load_state_dict_file

        sd = load_state_dict_file(args.params) if args.params else None
        tracker = BeatTracker(sd, device=args.device)
        res = tracker.track_file(args.audio, separation=args.separation, decoder=args.decoder)
        payload = {
            "n_frames": int(res.fused_pulse.shape[0]),
            "beat_times": [float(t) for t in (res.beat_times if res.beat_times is not None else [])],
        }
        print(json.dumps(payload))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(payload, fh, indent=2)


if __name__ == "__main__":
    main()
