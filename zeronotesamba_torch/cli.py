"""Command-line entry point of the port (python -m zeronotesamba_torch).

Subcommands, each with the JAX CLI's flags plus ``--device`` (default
``cuda``; ``cpu`` to run on the CPU):
    build-data   ETL a dataset directory into an npz record cache
    beat         k-fold CV beat-tracking experiment on a cached dataset
    pretext      self-supervised contrastive pretraining -> a .pth in the
                 reference key names (models/shift_pret_cnn_16.pth)
    infer        one file -> pulse + beats (JSON on stdout)

The JAX package's other subcommands are not ported yet (ROADMAP "Modules to
port", item 11).
"""

from __future__ import annotations

import argparse
import json

DEVICE_HELP = "torch device (default cuda; 'cpu' to run on the CPU)"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("zeronotesamba_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-data", help="ETL dataset -> npz cache")
    b.add_argument("dataset", choices=["ballroom", "gtzan", "hainsworth", "smc", "synthetic"])
    b.add_argument("--root", required=False, help="dataset root directory")
    b.add_argument("--out", required=True, help="output cache directory")
    b.add_argument("--separation", default="none", choices=["none", "hpss", "stems", "mix"])
    b.add_argument("--n-songs", type=int, default=16, help="synthetic only")
    b.add_argument("--device", default="cuda", help=DEVICE_HELP)

    t = sub.add_parser("beat", help="8-fold CV beat experiment")
    t.add_argument("--data", required=True, help="npz cache directory")
    t.add_argument("--status", default="vanilla", choices=["vanilla", "pretrained", "clmr", "bock"])
    t.add_argument("--pre", default="finetune", choices=["finetune", "frozen", "validation"])
    t.add_argument("--lr", type=float, default=1e-5)
    t.add_argument("--eval", default="dbn", choices=["dbn", "librosa", "threshold"])
    t.add_argument("--max-epochs", type=int, default=500)
    t.add_argument("--patience", type=int, default=20)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--folds", type=int, default=8)
    t.add_argument("--params", default=None,
                   help="initial weights: a state dict (.pth or .npz) in the reference key names")
    t.add_argument("--out", default=None, help="write results JSON here")
    t.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv compute dtype (params and loss stay float32)")
    t.add_argument("--steps-per-call", type=int, default=1,
                   help="accepted for the JAX CLI's flags; no effect here (SupervisedConfig)")
    t.add_argument("--freq-s2d", action="store_true", help="accepted for the JAX CLI's flags; no effect here")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda", help=DEVICE_HELP)

    pt = sub.add_parser("pretext", help="contrastive pretraining")
    pt.add_argument("--stem-root", default=None, help="new_data/-style stem dir (10%% kept for validation)")
    pt.add_argument("--bank", default=None, help="prebuilt .npz bank (train_bank/val_bank arrays)")
    pt.add_argument("--task", default="zerons", choices=["zerons", "clmr"])
    pt.add_argument("--epochs", type=int, default=250)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--checkpoint", default="models/shift_pret_cnn_16.pth",
                    help="best params path, .pth or .npz, in the reference key names")
    pt.add_argument("--data-parallel", action="store_true",
                    help="not ported yet (ROADMAP 'Modules to port', item 10); raises")
    pt.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="conv compute dtype (params and loss stay float32)")
    pt.add_argument("--selection", default="val_loss", choices=["val_loss", "proxy_f1"],
                    help="checkpoint selection: NT-Xent val loss (reference parity) "
                         "or zero-shot beat F1 on a labelled proxy set")
    pt.add_argument("--proxy-data", default=None, help="npz dataset cache for --selection proxy_f1")
    pt.add_argument("--freq-s2d", action="store_true", help="accepted for the JAX CLI's flags; no effect here")
    pt.add_argument("--steps-per-call", type=int, default=1,
                    help="accepted for the JAX CLI's flags; no effect here (make_staged_train_step)")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default="cuda", help=DEVICE_HELP)

    i = sub.add_parser("infer", help="track one audio file")
    i.add_argument("audio", help="wav file")
    i.add_argument("--params", default=None, help="state dict (.pth or .npz) in the reference key names")
    i.add_argument("--separation", default="hpss", choices=["hpss", "stems", "mix"])
    i.add_argument("--decoder", default="dbn", choices=["dbn", "threshold"])
    i.add_argument("--device", default="cuda", help=DEVICE_HELP)
    i.add_argument("--out", default=None, help="write JSON result here")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.cmd == "build-data":
        from zeronotesamba_torch.data.datasets import BUILDERS, build_synthetic

        if args.dataset == "synthetic":
            ds = build_synthetic(n_songs=args.n_songs, device=args.device)
        else:
            if not args.root:
                raise SystemExit("--root required for real datasets")
            ds = BUILDERS[args.dataset](args.root, separation=args.separation, device=args.device)
        ds.save(args.out)
        print(f"saved {len(ds)} songs to {args.out}")

    elif args.cmd == "beat":
        from zeronotesamba_torch.data.datasets import BeatDataset
        from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, run_beat_experiment, summarize
        from zeronotesamba_torch.models.weights import load_state_dict_file

        ds = BeatDataset.load(args.data)
        cfg = BeatExperimentConfig(
            status=args.status, pre=args.pre, lr=args.lr, eval_method=args.eval,
            n_folds=args.folds, max_epochs=args.max_epochs, patience=args.patience,
            batch_size=args.batch_size, seed=args.seed, compute_dtype=args.dtype,
            steps_per_call=args.steps_per_call,
            freq_s2d=(1,) if args.freq_s2d else (),
        )
        params = load_state_dict_file(args.params) if args.params else None
        results = run_beat_experiment(ds, cfg, init_params=params, device=args.device)
        _dump(args.out, summarize(results))

    elif args.cmd == "pretext":
        import numpy as np

        from zeronotesamba_torch.experiments.pretext_driver import (
            PretextRunConfig, build_bank_from_stem_root, train_pretext,
        )
        from zeronotesamba_torch.train.pretext import MESH_NOT_PORTED

        if args.data_parallel:
            raise NotImplementedError(MESH_NOT_PORTED)
        if args.bank:
            with np.load(args.bank) as z:
                train_bank, val_bank = z["train_bank"], z["val_bank"]
        elif args.stem_root:
            bank = build_bank_from_stem_root(args.stem_root, n_samples=10**9, seed=args.seed, device=args.device)
            n_val = max(1, len(bank) // 10)
            val_bank, train_bank = bank[:n_val], bank[n_val:]
        else:
            raise SystemExit("need --bank or --stem-root")
        proxy_ds = None
        if args.proxy_data:
            from zeronotesamba_torch.data.datasets import BeatDataset

            proxy_ds = BeatDataset.load(args.proxy_data)
        cfg = PretextRunConfig(task=args.task, num_epochs=args.epochs, batch_size=args.batch_size,
                               seed=args.seed, checkpoint_path=args.checkpoint,
                               compute_dtype=args.dtype, selection=args.selection,
                               proxy_dataset=proxy_ds, steps_per_call=args.steps_per_call,
                               freq_s2d=(1,) if args.freq_s2d else ())
        _, hist = train_pretext(train_bank, val_bank, cfg, device=args.device)
        print(json.dumps({"checkpoint": args.checkpoint, "epochs": len(hist["val_loss"]),
                          "best_val_loss": min(hist["val_loss"]), "restarts": hist["restarts"]}))

    elif args.cmd == "infer":
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
        _dump(args.out, payload)


def _dump(path, obj):
    if path:
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=2)


if __name__ == "__main__":
    main()
