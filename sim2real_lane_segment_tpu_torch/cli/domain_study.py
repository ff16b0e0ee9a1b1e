"""End-to-end domain-adaptation study: the five regimes on one target.

Counterpart of the JAX package's ``cli/domain_study.py``, with its flags.
It trains and evaluates the adaptation regimes on the same target test
split (``targetData/test``) and writes ``study_summary.json``:

  baseline  - source-only supervised training
  st        - source + a small labelled target subset (50/50 sampling)
  hm        - histogram-matched source (``cli.hist_match``) + S&T
  cyclegan  - a CycleGAN trained on the unpaired domains
              (``cli.train_cyclegan``), the source restyled
              (``cli.sim2real_convert``), then S&T
  mme       - minimax-entropy SSDA from the baseline weights

    python -m sim2real_lane_segment_tpu_torch.cli.domain_study \\
        --workdir domain_study --arch 67 --epochs 40

The study reads ``sourceData/{train,valid,test}`` and
``targetData/{train,valid,test}`` under ``--workdir``.  Rendering them
through the simulator is not ported yet: when a tree is absent the study
raises and says how to write it with the JAX package (the generation ->
training contract is the file system).  The render flags (``--episodes``,
``--steps``, the maps, ``--target_texture_pack``, ``--target_noise``)
are accepted for that reason and otherwise unused.

Resume, as the JAX study: regimes already in ``study_summary.json`` are
skipped, a regime whose ``results/<name>/best_weights.pt`` exists is
evaluated from it without refitting, and a fit that stopped mid-run
continues from its checkpoints; ``--force`` retrains everything.
``--device_cache`` goes to every data module as it is (the JAX study's
per-regime crash counter that turns the cache off is not ported).  Not
yet ported, and raising: ``--distill``, and training ``--arch lite``
(the default, as in JAX) or ``67r``/``encdec``.  Runs on the card unless
``main`` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import time

from . import common

log = logging.getLogger(__name__)


def _record_domain(out_dir: str) -> None:
    """The domain tree ``out_dir`` must exist: rendering is not ported."""
    if os.path.exists(os.path.join(out_dir, "train")):
        log.info("%s cached", out_dir)
        return
    raise NotImplementedError(
        f"{os.path.abspath(out_dir)}/train is absent, and rendering a "
        f"domain through the simulator is not yet ported to PyTorch. "
        f"Write sourceData/ and targetData/ (train, valid, test splits of "
        f"input/ and label/ PNGs) with the JAX package, then rerun here: "
        f"its domain_study renders both trees into its --workdir before "
        f"training, or render with its datagen, postprocess and "
        f"preprocess_db CLIs.")


def _build_tree(root: str, src: str, tgt: str, n_labelled: int,
                hm: bool, device=None) -> str:
    """The two-domain tree of one regime: ``source`` (all of ``src``'s
    train split), ``target/train`` (the first ``n_labelled`` target train
    frames), ``target/unlabelled`` (target train + valid inputs) and
    ``target/test``; with ``hm`` the source is then histogram-matched to
    the unlabelled target frames in place."""
    from . import hist_match

    shutil.rmtree(root, ignore_errors=True)

    def cp(pairs, dst, labelled=True):
        os.makedirs(f"{root}/{dst}/input", exist_ok=True)
        if labelled:
            os.makedirs(f"{root}/{dst}/label", exist_ok=True)
        for k, ip in enumerate(pairs):
            shutil.copy(ip, f"{root}/{dst}/input/{k:06d}.png")
            if labelled:
                shutil.copy(ip.replace("input", "label"),
                            f"{root}/{dst}/label/{k:06d}.png")

    src_train = sorted(glob.glob(f"{src}/train/input/*.png"))
    tgt_train = sorted(glob.glob(f"{tgt}/train/input/*.png"))
    tgt_valid = sorted(glob.glob(f"{tgt}/valid/input/*.png"))
    tgt_test = sorted(glob.glob(f"{tgt}/test/input/*.png"))
    cp(src_train, "source")
    cp(tgt_train[:n_labelled], "target/train")
    cp(tgt_train + tgt_valid, "target/unlabelled", labelled=False)
    cp(tgt_test, "target/test")
    if hm:
        hist_match.main(["--ds_source", f"{root}/source",
                         "--ds_reference", f"{root}/target/unlabelled",
                         "--batch_size", "16"], device=device)
    return root


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="domain_study")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--episodes", type=int, default=3,
                   help="rendering (not ported): episodes per domain")
    p.add_argument("--steps", type=int, default=144,
                   help="rendering (not ported): steps per episode")
    p.add_argument("--n_labelled", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--arch", default="lite",
                   choices=["67", "67r", "57", "103", "tiny", "lite",
                            "encdec"])
    p.add_argument("--source-map", default="loop_empty",
                   help="rendering (not ported)")
    p.add_argument("--target-map", default="zigzag",
                   help="rendering (not ported)")
    p.add_argument("--target_texture_pack", default=None,
                   help="rendering (not ported)")
    p.add_argument("--target_noise", type=float, default=0.0,
                   help="rendering (not ported)")
    p.add_argument("--regimes", nargs="+",
                   default=["baseline", "st", "hm", "cyclegan", "mme"])
    p.add_argument("--batch_size", "-b", type=int, default=32,
                   help="train batch size (reference recipe: 64)")
    p.add_argument("--cg_batch", type=int, default=4,
                   help="CycleGAN training batch size")
    p.add_argument("--device_cache", action="store_true",
                   help="device-resident splits + on-device batch gather "
                        "(data/device_cache.py)")
    p.add_argument("--cg_epochs", type=int, default=30,
                   help="CycleGAN training epochs for the cyclegan regime")
    p.add_argument("--distill", action="store_true",
                   help="distil LaneNetLite students (not yet ported)")
    p.add_argument("--distill_epochs", type=int, default=None,
                   help="distillation budget (not yet ported)")
    p.add_argument("--force", action="store_true",
                   help="retrain regimes even if a finished result exists "
                        "in the workdir (default: resume)")
    return p


def main(args=None, device=None) -> dict:
    """Run the study; ``device`` defaults to ``cuda`` and raises without a
    card."""
    import torch

    from ..core.runtime import resolve_device
    from ..data.modules import (SimulatorDataModule, TwoDomainDataModule,
                                TwoDomainMMEDataModule)
    from ..train.checkpoint import load_weights
    from ..train.loop import fit, run_eval
    from ..train.mme import MMETrainer
    from ..train.supervised import SupervisedTrainer
    from . import sim2real_convert, train_cyclegan
    from .test import build_model

    common.setup_logging()
    args = build_parser().parse_args(args)
    if args.distill:
        raise NotImplementedError(
            "--distill (LaneNetLite students) is not yet ported to PyTorch")
    device = resolve_device(device)

    os.makedirs(args.workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(args.workdir)
    try:
        _record_domain("sourceData")
        _record_domain("targetData")

        def trainer(cls, seed: int):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)  # the initial weights
                model = build_model(args.arch, 4)
            return cls(num_cls=4, augment=True, lr=args.lr, model=model,
                       device=device)

        def data(cls, root):
            dm = cls(root, batch_size=args.batch_size, seed=42,
                     load_into_memory=True, device_cache=args.device_cache,
                     device=device)
            dm.setup()
            return dm

        def fit_regime(tr, dm, name):
            fit(tr, dm, max_epochs=args.epochs, out_dir=f"results/{name}",
                resume=not args.force)

        results: dict = {}
        if os.path.exists("study_summary.json") and not args.force:
            with open("study_summary.json") as f:
                results = json.load(f)
            log.info("resuming: %s already in study_summary.json",
                     sorted(results) or "nothing")

        def save_summary():
            # after every regime, so a crash mid-study loses one regime
            with open("study_summary.json", "w") as f:
                json.dump(results, f, indent=2)

        def restore(name, tr) -> bool:
            """Load the best weights of a regime that already trained."""
            p = f"results/{name}/best_weights.pt"
            if args.force or not os.path.exists(p):
                return False
            log.info("%s: restoring %s", name, p)
            load_weights(p, tr.model)
            return True

        def target_test_batches():
            tgt = SimulatorDataModule("targetData",
                                      batch_size=args.batch_size, seed=42)
            tgt.setup()
            return tgt.test_batches()

        def evaluate(name, tr, t0):
            results[name] = run_eval(tr.eval_step, target_test_batches())
            save_summary()
            log.info("%s: %s (%.0fs)", name, results[name],
                     time.time() - t0)

        if "baseline" in args.regimes or "mme" in args.regimes:
            t0 = time.time()
            base = trainer(SupervisedTrainer, 0)
            if not restore("baseline", base):
                fit_regime(base, data(SimulatorDataModule, "sourceData"),
                           "baseline")
            if "baseline" not in results or args.force:
                evaluate("baseline", base, t0)

        for name in ("st", "hm"):
            if name not in args.regimes:
                continue
            if name in results and not args.force:
                log.info("%s: cached in study_summary.json", name)
                continue
            t0 = time.time()
            tr = trainer(SupervisedTrainer, 1)
            if not restore(name, tr):
                root = _build_tree(f"srd_{name}", "sourceData", "targetData",
                                   args.n_labelled, hm=(name == "hm"),
                                   device=device)
                fit_regime(tr, data(TwoDomainDataModule, root), name)
            # every regime tests on the same target test frames
            evaluate(name, tr, t0)

        if "cyclegan" in args.regimes and not (
                "cyclegan" in results and not args.force):
            t0 = time.time()
            tr = trainer(SupervisedTrainer, 2)
            if not restore("cyclegan", tr):
                root = _build_tree("srd_cg", "sourceData", "targetData",
                                   args.n_labelled, hm=False)
                train_cyclegan.main([
                    "--source_dir", f"{root}/source/input",
                    "--target_dir", f"{root}/target/unlabelled/input",
                    "--out", "results/cyclegan_gen",
                    "--epochs", str(args.cg_epochs), "-b",
                    str(args.cg_batch)], device=device)
                # restyle the source inputs in place, then train like S&T
                sim2real_convert.main([
                    "--dataPath", f"{root}/source",
                    "--modelWeightsPath", "results/cyclegan_gen/g_ab.pt"],
                    device=device)
                fit_regime(tr, data(TwoDomainDataModule, root), "cyclegan")
            evaluate("cyclegan", tr, t0)
        elif "cyclegan" in args.regimes:
            log.info("cyclegan: cached in study_summary.json")

        if "mme" in args.regimes and not ("mme" in results
                                          and not args.force):
            t0 = time.time()
            mme = trainer(MMETrainer, 3)
            if not restore("mme", mme):
                root = _build_tree("srd_mme", "sourceData", "targetData",
                                   args.n_labelled, hm=False)
                # from the baseline's best weights, both optimizers fresh
                mme.from_pretrained("results/baseline/best_weights.pt")
                fit_regime(mme, data(TwoDomainMMEDataModule, root), "mme")
            evaluate("mme", mme, t0)
        elif "mme" in args.regimes:
            log.info("mme: cached in study_summary.json")

        save_summary()
        print("STUDY SUMMARY (target-domain test):")
        for k, v in results.items():
            print(f"  {k:16s} acc {v['acc']:.2f}  iou {v['iou']:.2f}")
        return results
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()
