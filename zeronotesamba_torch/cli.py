"""Command-line entry point of the port (python -m zeronotesamba_torch).

Subcommands, each with the JAX CLI's flags; those that run a model also
take ``--device`` (default ``cuda``; ``cpu`` to run on the CPU):
    build-data   ETL a dataset directory into an npz record cache
    beat         k-fold CV beat-tracking experiment on a cached dataset
    cross        cross-dataset experiment (train X, test Y)
    few-shot     training-set size sweep
    pretext      self-supervised contrastive pretraining -> a .pth in the
                 reference key names (models/shift_pret_cnn_16.pth)
    old-school   Ellis DP baseline on raw audio (host only)
    measures     embedding information measures over a dataset, or
                 (--status std) the NT-Xent validation over a bank
    infer        one file -> pulse + beats (JSON on stdout)
    resave       re-sample every wav under a directory tree (host only)
    track-dir    batch-track every wav in a directory
    train-separator  train the learned drum/rest mask separator -> an .npz
    demo-suite   the full experiment grid on synthetic corpora
    export-xlsx  render a results directory's JSONs as the six workbooks (host only)

Where the JAX CLI's default path holds committed files, the port's default
is a git-ignored one: ``train-separator --checkpoint``
(models/separator_torch.npz), ``demo-suite --out``
(results/synthetic_torch) and ``export-xlsx --out``
(results/synthetic_torch/xlsx). ``--sep-model`` defaults to the shipped
separator exported to ``zeronotesamba_torch/assets/separator.npz``.
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
                   help="K > 1: train each run of K full batches of one bucket in one call, "
                        "one CUDA graph on a card (the plain K-step loop on the CPU); same numerics")
    t.add_argument("--freq-s2d", action="store_true", help="accepted for the JAX CLI's flags; no effect here")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda", help=DEVICE_HELP)

    c = sub.add_parser("cross", help="cross-dataset experiment")
    c.add_argument("--train-data", required=True)
    c.add_argument("--test-data", required=True)
    for a in (("--status", "vanilla"), ("--pre", "finetune")):
        c.add_argument(a[0], default=a[1])
    c.add_argument("--lr", type=float, default=1e-5)
    c.add_argument("--eval", default="dbn")
    c.add_argument("--max-epochs", type=int, default=500)
    c.add_argument("--patience", type=int, default=20)
    c.add_argument("--batch-size", type=int, default=8)
    c.add_argument("--folds", type=int, default=8, help="folds of the train dataset")
    c.add_argument("--params", default=None, help="initial weights (.pth or .npz) in the reference key names")
    c.add_argument("--out", default=None)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", default="cuda", help=DEVICE_HELP)

    f = sub.add_parser("few-shot", help="training-set size sweep")
    f.add_argument("--data", required=True)
    f.add_argument("--status", default="vanilla")
    f.add_argument("--pre", default="finetune")
    f.add_argument("--lr", type=float, default=1e-5)
    f.add_argument("--sizes", default="1,2,4,8,16")
    f.add_argument("--repeats", type=int, default=3)
    f.add_argument("--max-epochs", type=int, default=100)
    f.add_argument("--patience", type=int, default=10)
    f.add_argument("--batch-size", type=int, default=8)
    f.add_argument("--params", default=None, help="initial weights (.pth or .npz) in the reference key names")
    f.add_argument("--out", default=None)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--device", default="cuda", help=DEVICE_HELP)

    pt = sub.add_parser("pretext", help="contrastive pretraining")
    pt.add_argument("--stem-root", default=None, help="new_data/-style stem dir (10%% kept for validation)")
    pt.add_argument("--bank", default=None, help="prebuilt .npz bank (train_bank/val_bank arrays)")
    pt.add_argument("--task", default="zerons", choices=["zerons", "clmr"])
    pt.add_argument("--epochs", type=int, default=250)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--checkpoint", default="models/shift_pret_cnn_16.pth",
                    help="best params path, .pth or .npz, in the reference key names")
    pt.add_argument("--data-parallel", action="store_true",
                    help="track-parallel over every visible card, one NCCL rank each (or the torchrun world; "
                         "with --device cpu, one gloo rank)")
    pt.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="conv compute dtype (params and loss stay float32)")
    pt.add_argument("--selection", default="val_loss", choices=["val_loss", "proxy_f1"],
                    help="checkpoint selection: NT-Xent val loss (reference parity) "
                         "or zero-shot beat F1 on a labelled proxy set")
    pt.add_argument("--proxy-data", default=None, help="npz dataset cache for --selection proxy_f1")
    pt.add_argument("--freq-s2d", action="store_true", help="accepted for the JAX CLI's flags; no effect here")
    pt.add_argument("--steps-per-call", type=int, default=1,
                    help="S > 1: pad each epoch to a multiple of S updates and run them S to a call, "
                         "one CUDA graph on a card (the plain S-step loop on the CPU); forced to 1 "
                         "with --data-parallel")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default="cuda", help=DEVICE_HELP)

    o = sub.add_parser("old-school", help="Ellis DP baseline on raw audio")
    o.add_argument("--data", required=True, help="npz cache (uses stored beat times)")
    o.add_argument("--audio-root", required=True, help="directory of wavs")

    m = sub.add_parser("measures", help="embedding information measures")
    m.add_argument("--data", default=None, help="npz dataset cache (not needed for --status std)")
    m.add_argument("--status", default="van", help="reference meastatus label (van/rand/drums/ros/mix/std/bock)")
    m.add_argument("--model", default=None, choices=["vanilla", "pretrained", "bock"],
                   help="override the model family (default: inferred from the data; "
                        "'bock' measures the TCN baseline's activations, reference measures.py:270-277)")
    m.add_argument("--stream", default="fused", choices=["fused", "anchor", "positive"],
                   help="which pulse to measure (reference drums=positive, ros=anchor, mix=fused)")
    m.add_argument("--bank", default=None, help="npz bank with val_bank array (--status std)")
    m.add_argument("--params", default=None, help="weights (.pth or .npz) in the reference key names")
    m.add_argument("--out", default="results/measures")
    m.add_argument("--device", default="cuda", help=DEVICE_HELP)

    i = sub.add_parser("infer", help="track one audio file")
    i.add_argument("audio", help="wav file")
    i.add_argument("--params", default=None, help="state dict (.pth or .npz) in the reference key names")
    _add_tracking(i)
    i.add_argument("--out", default=None, help="write JSON result here")

    rs = sub.add_parser("resave", help="re-sample every wav under a directory tree")
    rs.add_argument("audio_root", help="directory tree of .wav files")
    rs.add_argument("--out", required=True, help="output root (structure preserved)")
    rs.add_argument("--rate", type=int, default=44100, help="target sample rate")

    ts = sub.add_parser("train-separator", help="train the learned drum/rest mask separator")
    ts.add_argument("--steps", type=int, default=1500)
    ts.add_argument("--batch-size", type=int, default=8)
    ts.add_argument("--lr", type=float, default=3e-4)
    ts.add_argument("--train-songs", type=int, default=40)
    ts.add_argument("--val-songs", type=int, default=8)
    ts.add_argument("--checkpoint", default="models/separator_torch.npz",
                    help="best-SI-SDR params, an .npz of the MaskNet's Flax tree")
    ts.add_argument("--out", default=None, help="write the SI-SDR report JSON here")
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--device", default="cuda", help=DEVICE_HELP)

    d = sub.add_parser("demo-suite", help="reproduce the full experiment grid on synthetic data")
    d.add_argument("--out", default="results/synthetic_torch")
    d.add_argument("--songs", type=int, default=24)
    d.add_argument("--pretext-epochs", type=int, default=120)
    d.add_argument("--max-epochs", type=int, default=60)
    d.add_argument("--folds", type=int, default=4)
    d.add_argument("--clmr", action="store_true", help="also run the CLMR pretext + finetune arm")
    d.add_argument("--difficulty", type=float, default=1.0,
                   help="corpus hardness scale (0 = clean corpora)")
    d.add_argument("--pretext-selection", default="proxy_f1", choices=["proxy_f1", "val_loss"],
                   help="pretext checkpoint selection: beat-proxy F1 or reference-parity val loss")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--device", default="cuda", help=DEVICE_HELP)

    x = sub.add_parser("export-xlsx", help="render evidence JSONs as the reference's six results workbooks")
    x.add_argument("--src", default="results/synthetic")
    x.add_argument("--out", default="results/synthetic_torch/xlsx")

    td = sub.add_parser("track-dir", help="batch-track every wav in a directory")
    td.add_argument("audio_dir")
    td.add_argument("--params", default=None, help="state dict (.pth or .npz) in the reference key names")
    _add_tracking(td)
    td.add_argument("--out", required=True, help="output JSON (one entry per file)")
    return ap


def _add_tracking(p: argparse.ArgumentParser) -> None:
    """The model, separation, decoder and device flags of infer and track-dir."""
    p.add_argument("--model", default="down_cnn", choices=["down_cnn", "beat_this"],
                   help="down_cnn: the fused Down_CNN; beat_this: Beat This! on the mix (--params: a .ckpt "
                        "in the source's key names)")
    p.add_argument("--separation", default=None, choices=["hpss", "stems", "learned", "mix", "none"],
                   help="default hpss (down_cnn), none (beat_this, which takes no other)")
    p.add_argument("--sep-model", default=None,
                   help="mask-net params for --separation learned, an .npz of its Flax tree "
                        "(default: the shipped zeronotesamba_torch/assets/separator.npz)")
    p.add_argument("--decoder", default=None, choices=["dbn", "librosa", "threshold", "peaks"],
                   help="default dbn (down_cnn), peaks (beat_this, which takes no other)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)


def _tracker(args) -> tuple:
    """The --model's tracker (``infer.TRACKERS``) on --params, and its
    track_file arguments: the tracker's ``TRACK_DEFAULTS``, each flag given
    over its default."""
    from zeronotesamba_torch.infer import TRACKERS

    cls = TRACKERS[args.model]
    tracker = cls(cls.load_file(args.params) if args.params else None, device=args.device)
    return tracker, {k: v if getattr(args, k) is None else getattr(args, k) for k, v in cls.TRACK_DEFAULTS.items()}


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

        ds = BeatDataset.load(args.data)
        cfg = BeatExperimentConfig(
            status=args.status, pre=args.pre, lr=args.lr, eval_method=args.eval,
            n_folds=args.folds, max_epochs=args.max_epochs, patience=args.patience,
            batch_size=args.batch_size, seed=args.seed, compute_dtype=args.dtype,
            steps_per_call=args.steps_per_call,
            freq_s2d=(1,) if args.freq_s2d else (),
        )
        results = run_beat_experiment(ds, cfg, init_params=_load_params(args.params), device=args.device)
        _dump(args.out, summarize(results))

    elif args.cmd == "cross":
        from zeronotesamba_torch.data.datasets import BeatDataset
        from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, summarize
        from zeronotesamba_torch.experiments.cross import run_cross_experiment

        cfg = BeatExperimentConfig(
            status=args.status, pre=args.pre, lr=args.lr, eval_method=args.eval, n_folds=args.folds,
            max_epochs=args.max_epochs, patience=args.patience, batch_size=args.batch_size, seed=args.seed,
        )
        results = run_cross_experiment(
            BeatDataset.load(args.train_data), BeatDataset.load(args.test_data), cfg,
            init_params=_load_params(args.params), device=args.device,
        )
        _dump(args.out, summarize(results))

    elif args.cmd == "few-shot":
        from zeronotesamba_torch.data.datasets import BeatDataset
        from zeronotesamba_torch.experiments.beat import BeatExperimentConfig
        from zeronotesamba_torch.experiments.few_shot import run_few_shot

        cfg = BeatExperimentConfig(
            status=args.status, pre=args.pre, lr=args.lr, max_epochs=args.max_epochs,
            patience=args.patience, batch_size=args.batch_size, seed=args.seed,
        )
        sizes = [int(s) for s in args.sizes.split(",")]
        res = run_few_shot(BeatDataset.load(args.data), cfg, train_sizes=sizes, repeats=args.repeats,
                           init_params=_load_params(args.params), device=args.device)
        _dump(args.out, {str(k): v for k, v in res.items()})

    elif args.cmd == "pretext":
        if not (args.bank or args.stem_root):
            raise SystemExit("need --bank or --stem-root")
        if args.data_parallel:
            from zeronotesamba_torch.parallel.launch import launch

            launch(_pretext, args.device, args)
        else:
            _pretext(None, args)

    elif args.cmd == "train-separator":
        from zeronotesamba_torch.train.separator import (
            SeparatorConfig, hpss_baseline_si_sdr, synth_bank, train_separator,
        )

        cfg = SeparatorConfig(steps=args.steps, batch_size=args.batch_size, lr=args.lr,
                              seed=args.seed, checkpoint_path=args.checkpoint)
        _, hist = train_separator(cfg, train_songs=args.train_songs, val_songs=args.val_songs, device=args.device)
        base_d, base_r = hpss_baseline_si_sdr(synth_bank(args.val_songs, 12.0, args.seed + 999), device=args.device)
        payload = {
            "learned_si_sdr_drums": max(hist["si_sdr_drums"]),
            "learned_si_sdr_rest": max(hist["si_sdr_rest"]),
            "hpss_si_sdr_drums": base_d,
            "hpss_si_sdr_rest": base_r,
            "history": hist,
        }
        print(json.dumps({k: v for k, v in payload.items() if k != "history"}, indent=2))
        _dump(args.out, payload)

    elif args.cmd == "demo-suite":
        from zeronotesamba_torch.experiments.demo_suite import DemoSuiteConfig, run_demo_suite

        cfg = DemoSuiteConfig(
            out_dir=args.out, n_songs=args.songs, pretext_epochs=args.pretext_epochs,
            max_epochs=args.max_epochs, folds=args.folds, clmr=args.clmr,
            difficulty=args.difficulty, seed=args.seed,
            pretext_selection=args.pretext_selection,
        )
        print(json.dumps(run_demo_suite(cfg, device=args.device), indent=2))

    elif args.cmd == "export-xlsx":
        from zeronotesamba_torch.experiments.report_xlsx import export

        print(json.dumps(export(args.src, args.out)))

    elif args.cmd == "old-school":
        import os

        import numpy as np

        from zeronotesamba_torch.data import audio_io
        from zeronotesamba_torch.data.datasets import BeatDataset
        from zeronotesamba_torch.decode.ellis import beat_track_signal
        from zeronotesamba_torch.metrics.beat import evaluate_beats

        ds = BeatDataset.load(args.data)
        all_scores = []
        for rec in ds:
            wav = os.path.join(args.audio_root, rec.name)
            if not os.path.exists(wav):
                continue
            sig, _ = audio_io.load_audio(wav, target_sr=16000)
            all_scores.append(evaluate_beats(rec.beat_times, beat_track_signal(sig)))
        if not all_scores:
            raise SystemExit(f"no audio files from {args.data} found under {args.audio_root}")
        arr = np.asarray(all_scores)
        for i, n in enumerate(["F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain"]):
            print(f"Mean {n} is {arr[:, i].mean():.3f} +- {arr[:, i].std():.3f}.")

    elif args.cmd == "measures":
        import numpy as np

        if args.status == "std":
            # NT-Xent validation re-run over a saved bank (reference
            # measures.py:394-429): contrastive loss and similarities.
            import torch

            from zeronotesamba_torch.device import resolve_device
            from zeronotesamba_torch.experiments.pretext_driver import fixed_val_shifts
            from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_eval_step

            if not args.bank:
                raise SystemExit("--status std requires --bank (npz with val_bank)")
            with np.load(args.bank) as z:
                val_bank = z["val_bank"]
            pcfg = PretextConfig()
            dev = resolve_device(args.device)
            state = init_pretext_state(pcfg, 0, params=_load_params(args.params), device=dev)
            ev = make_eval_step(pcfg)
            losses, poss, negs = [], [], []
            for vb in fixed_val_shifts(val_bank, pcfg, 0):
                loss, pc, nc = ev(state, torch.as_tensor(vb, device=dev))
                losses.append(float(loss))
                poss.append(float(pc))
                negs.append(float(nc))
            payload = {"val_loss": float(np.mean(losses)), "pos_sim": float(np.mean(poss)),
                       "neg_sim": float(np.mean(negs))}
            print(json.dumps(payload, indent=2))
            _dump(args.out + "_std.json" if args.out else None, payload)
            return

        from zeronotesamba_torch.data.datasets import BeatDataset
        from zeronotesamba_torch.experiments.measures import measure_arm, write_measures_report

        if not args.data:
            raise SystemExit("--data required (except for --status std)")
        ds = BeatDataset.load(args.data)
        status = args.model or ("pretrained" if ds[0].vqt.shape[0] == 2 else "vanilla")
        # Per-stream pulses (reference meastatus 'ros'/'drums' measure the
        # anchor / percussive streams separately, measures.py:341-392).
        table = measure_arm(ds, status, _load_params(args.params), stream=args.stream, device=args.device)
        write_measures_report(table, args.out, args.status)
        print(json.dumps(table, indent=2))

    elif args.cmd == "infer":
        tracker, kw = _tracker(args)
        payload = tracker.track_file(args.audio, **kw).to_json()
        print(json.dumps(payload))
        _dump(args.out, payload)

    elif args.cmd == "resave":
        # Dataset re-sample utility (reference measures.gtzan_44100,
        # zeroNoteSamba/measures.py:280-305, generalized to any tree and rate).
        import os

        from zeronotesamba_torch.data import audio_io

        n = 0
        for dirpath, _, files in os.walk(args.audio_root):
            rel = os.path.relpath(dirpath, args.audio_root)
            for f in sorted(files):
                if not f.endswith(".wav"):
                    continue
                sig, _ = audio_io.load_audio(os.path.join(dirpath, f), target_sr=args.rate)
                out_dir = os.path.join(args.out, rel) if rel != "." else args.out
                os.makedirs(out_dir, exist_ok=True)
                audio_io.write_wav(os.path.join(out_dir, f), sig, args.rate)
                n += 1
        print(f"resaved {n} files at {args.rate} Hz -> {args.out}")

    elif args.cmd == "track-dir":
        import os

        tracker, kw = _tracker(args)
        results = {}
        for f in sorted(os.listdir(args.audio_dir)):
            if not f.endswith(".wav"):
                continue
            try:
                res = tracker.track_file(os.path.join(args.audio_dir, f), **kw)
                results[f] = [float(t) for t in res.beat_times]
            except (ValueError, OSError) as e:
                results[f] = {"error": str(e)}
        _dump(args.out, results)
        print(f"tracked {len(results)} files -> {args.out}")


def _pretext(mesh, args):
    """The pretext subcommand on one rank (``mesh`` None: on ``--device``).
    Rank 0 alone loads or builds the bank; the other ranks map its train
    bank read-only and read their shard (parallel/mesh.host_array_from_rank0),
    and need no validation bank. Rank 0 prints the JSON line; built from
    ``--stem-root``, it counts the bank's items and the VQT kernel launches
    of its build."""
    import numpy as np

    from zeronotesamba_torch.experiments.pretext_driver import (
        PretextRunConfig, build_bank_from_stem_root, train_pretext,
    )
    from zeronotesamba_torch.utils import profiling

    device = args.device if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    train_bank = val_bank = None
    built = {}
    if lead and args.bank:
        with np.load(args.bank) as z:
            train_bank, val_bank = z["train_bank"], z["val_bank"]
    elif lead:
        before = profiling.totals("vqt_launch.")
        bank = build_bank_from_stem_root(args.stem_root, n_samples=10**9, seed=args.seed, device=device)
        built = {"bank_items": len(bank),
                 "bank_vqt_launches": {k: n - before.get(k, 0) for k, n in profiling.totals("vqt_launch.").items()}}
        n_val = max(1, len(bank) // 10)
        val_bank, train_bank = bank[:n_val], bank[n_val:]
    if mesh is not None:
        from zeronotesamba_torch.parallel.mesh import host_array_from_rank0

        train_bank = host_array_from_rank0(train_bank, mesh)
    proxy_ds = None
    if args.proxy_data:
        from zeronotesamba_torch.data.datasets import BeatDataset

        proxy_ds = BeatDataset.load(args.proxy_data)
    cfg = PretextRunConfig(task=args.task, num_epochs=args.epochs, batch_size=args.batch_size,
                           seed=args.seed, checkpoint_path=args.checkpoint,
                           compute_dtype=args.dtype, selection=args.selection,
                           proxy_dataset=proxy_ds, steps_per_call=args.steps_per_call,
                           freq_s2d=(1,) if args.freq_s2d else ())
    _, hist = train_pretext(train_bank, val_bank, cfg, mesh=mesh, device=device)
    if lead:
        out = {"checkpoint": args.checkpoint, "epochs": len(hist["val_loss"]),
               "best_val_loss": min(hist["val_loss"]), "restarts": hist["restarts"], **built}
        if mesh is not None:
            out["ranks"] = mesh.size
        print(json.dumps(out), flush=True)


def _load_params(path):
    """A weights file, or None: a .pth or .npz in the reference key names, or
    an .npz of a Flax tree (models/weights.load_state_dict_file)."""
    if not path:
        return None
    from zeronotesamba_torch.models.weights import load_state_dict_file

    return load_state_dict_file(path)


def _dump(path, obj):
    if path:
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=2)


if __name__ == "__main__":
    main()
