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

With ``--distill`` a LaneNetLite student is then distilled from each
regime's best weights (``train.distill.DistillTrainer``) on the tree that
regime trained on (baseline on ``sourceData``; the others on their
two-domain tree through ``TwoDomainMMEDataModule``, so the KD term also
sees the unlabelled target frames) for ``--distill_epochs`` (default
``--epochs``) epochs, and scored on the same target test split, as rows
``student_<regime>``.

    python -m sim2real_lane_segment_tpu_torch.cli.domain_study \\
        --workdir domain_study --arch 67 --epochs 40

The study reads ``sourceData/{train,valid,test}`` and
``targetData/{train,valid,test}`` under ``--workdir`` and renders a tree
that is absent, as the JAX study does: ``--episodes`` expert rollouts of
``--steps`` steps (fisheye on) of ``--source-map`` (seed 0) and
``--target-map`` (seed 9) through ``cli.datagen``'s rollouts,
``cli.postprocess`` and ``cli.preprocess_db``.  The target then takes a
white-balance shift, or with ``--target_texture_pack`` (a pack directory,
or ``auto`` for ``sim.textures.generate_photo_pack``) the photographic
tiles instead, and ``--target_noise`` sensor noise (numpy's draws, the
JAX study's).

Resume, as the JAX study: regimes already in ``study_summary.json`` are
skipped, a regime whose ``results/<name>/best_weights.pt`` exists is
evaluated from it without refitting, and a fit that stopped mid-run
continues from its checkpoints; ``--force`` retrains everything.
``--device_cache`` goes to every data module as it is (the JAX study's
per-regime crash counter that turns the cache off is not ported).
``--arch lite`` (the default, as in JAX) trains LaneNetLite in every
regime; every other arch of ``cli.train`` is accepted too (``encdec``
has no featureExtractor/classifier split, so its ``mme`` regime raises,
as the JAX trainer fails on it).  Runs on the card unless ``main`` is
given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import time

from ..core import runtime
from . import common

log = logging.getLogger(__name__)

# (width, height) of the rendered domains: the reference's recordings
RECORD_SIZE = (640, 480)


def _record_domain(out_dir: str, map_name: str, *, seed: int, episodes: int,
                   steps: int, distortion: bool, color_shift=None,
                   texture_pack=None, noise_sigma=None,
                   device=None) -> None:
    """Render one domain's tree ``out_dir/{train,valid,test}`` unless it is
    there: ``episodes`` expert rollouts of ``steps`` steps (in chunks of
    24, as the JAX study) on ``map_name`` at ``RECORD_SIZE``, through
    ``postprocess`` and ``preprocess_db``; then a colour shift ``(scale,
    shift)`` and numpy sensor noise of ``noise_sigma``
    (``default_rng(seed + 77)``, the JAX study's draws) over every input
    PNG."""
    import numpy as np
    import torch

    from ..data.png import read_png, write_png
    from ..data.videoio import AsyncVideoWriter
    from ..sim import lanes, render, rollout
    from ..sim.maps import builtin_map
    from . import postprocess, preprocess_db

    if os.path.exists(os.path.join(out_dir, "train")):
        log.info("%s cached", out_dir)
        return
    m = builtin_map(map_name)
    scene = render.build_scene(m, seed=seed, texture_pack=texture_pack,
                               device=device)
    la = lanes.build_lane_arrays(m, device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    rec = out_dir + "_rec"
    os.makedirs(rec, exist_ok=True)
    for seq in range(episodes):
        pos, angle = rollout.sample_spawns(m, la, rng, 1, device)
        with AsyncVideoWriter(f"{rec}/{seq:03d}_orig.avi",
                              frame_size=RECORD_SIZE) as wo, \
                AsyncVideoWriter(f"{rec}/{seq:03d}_annot.avi",
                                 frame_size=RECORD_SIZE) as wa:
            done = 0
            while done < steps:
                batch = rollout.expert_rollout(
                    scene, la, gen, pos, angle, tile_size=m.tile_size,
                    n_steps=24, height=RECORD_SIZE[1],
                    width=RECORD_SIZE[0], distortion=distortion,
                    procedural=texture_pack is None)
                wo.write(batch.orig[:, 0].cpu().numpy()[..., ::-1])
                wa.write(batch.annot[:, 0].cpu().numpy()[..., ::-1])
                pos, angle = batch.pos[-1], batch.angle[-1]
                done += 24
        log.info("%s: episode %d rendered", map_name, seq)
    raw = out_dir + "_raw"
    postprocess.main(["-id", rec, "-od", raw], device=device)
    preprocess_db.main(["--dbType", "sim", "--dataPath", raw], device=device)
    if color_shift is not None or noise_sigma:
        png_rng = np.random.default_rng(seed + 77)
        for split in ("train", "valid", "test"):
            for p in sorted(glob.glob(f"{raw}/{split}/input/*.png")):
                img = read_png(p).astype(np.float32)
                if color_shift is not None:
                    scale, shift = color_shift
                    img = img * np.asarray(scale) + shift
                if noise_sigma:
                    # per-frame sensor noise (shot/read noise proxy): the
                    # real camera's grain the sim lacks
                    img = img + png_rng.normal(0.0, noise_sigma, img.shape)
                write_png(p, np.clip(img, 0, 255).astype(np.uint8))
    os.rename(raw, out_dir)


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
                   help="rendered episodes per domain")
    p.add_argument("--steps", type=int, default=144,
                   help="steps per rendered episode")
    p.add_argument("--n_labelled", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--arch", default="lite",
                   choices=["67", "67r", "57", "103", "tiny", "lite",
                            "encdec"])
    p.add_argument("--source-map", default="loop_empty")
    p.add_argument("--target-map", default="zigzag")
    p.add_argument("--target_texture_pack", default=None,
                   help="render the TARGET domain through a photographic "
                        "texture pack instead of the procedural shader: a "
                        "pack directory, or 'auto' to generate one "
                        "(sim/textures.generate_photo_pack), the closest "
                        "in-environment proxy for the real camera domain")
    p.add_argument("--target_noise", type=float, default=0.0,
                   help="gaussian sensor-noise sigma added to target "
                        "input frames (real-camera grain proxy)")
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
                   help="after the regimes, distill a LaneNetLite student "
                        "from each regime's best weights on that regime's "
                        "training tree and score it on the same target "
                        "test split (rows student_<regime>)")
    p.add_argument("--distill_epochs", type=int, default=None,
                   help="distillation budget per student (default: "
                        "--epochs)")
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
    runtime.set_float32_precision()
    device = resolve_device(device)

    os.makedirs(args.workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(args.workdir)
    try:
        _record_domain("sourceData", args.source_map, seed=0,
                       episodes=args.episodes, steps=args.steps,
                       distortion=True, device=device)
        pack = args.target_texture_pack
        if pack == "auto":
            from ..sim.textures import generate_photo_pack
            pack = generate_photo_pack("photo_pack", seed=9)
        _record_domain("targetData", args.target_map, seed=9,
                       episodes=args.episodes, steps=args.steps,
                       distortion=True, texture_pack=pack,
                       noise_sigma=args.target_noise,
                       # the colour shift models a camera white-balance
                       # offset; with a texture pack the appearance shift
                       # comes from the photographic tiles themselves
                       color_shift=(None if pack else
                                    ((1.05, 0.85, 0.7), -12)),
                       device=device)

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

        if args.distill:
            _distill_students(args, results, data, evaluate, device)

        save_summary()
        print("STUDY SUMMARY (target-domain test):")
        for k, v in results.items():
            print(f"  {k:16s} acc {v['acc']:.2f}  iou {v['iou']:.2f}")
        return results
    finally:
        os.chdir(cwd)


def _distill_students(args, results, data, evaluate, device) -> None:
    """A LaneNetLite student distilled from each regime's best weights
    (``results/<regime>/best_weights.pt``, the study's ``--arch``) on
    that regime's tree, scored as ``student_<regime>``; skipped when the
    weights or the tree are missing, or the row is in the summary."""
    import torch

    from ..data.modules import SimulatorDataModule, TwoDomainMMEDataModule
    from ..models.lanenet_lite import LaneNetLite
    from ..train.checkpoint import load_weights
    from ..train.distill import DistillTrainer
    from ..train.loop import fit
    from .test import build_model

    trees = {"baseline": ("sourceData", SimulatorDataModule),
             "st": ("srd_st", TwoDomainMMEDataModule),
             "hm": ("srd_hm", TwoDomainMMEDataModule),
             "cyclegan": ("srd_cg", TwoDomainMMEDataModule),
             "mme": ("srd_mme", TwoDomainMMEDataModule)}
    epochs = args.distill_epochs or args.epochs
    for name in args.regimes:
        sk = f"student_{name}"
        if sk in results and not args.force:
            log.info("%s: cached in study_summary.json", sk)
            continue
        teacher_path = f"results/{name}/best_weights.pt"
        root, module = trees[name]
        missing = [p for p in (teacher_path, root) if not os.path.exists(p)]
        if missing:
            log.warning("%s: missing %s, skipping the student", sk,
                        missing[0])
            continue
        t0 = time.time()
        teacher = build_model(args.arch, 4)
        load_weights(teacher_path, teacher)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(4)  # the student's initial weights
            student = LaneNetLite(n_classes=4)
        tr = DistillTrainer(teacher=teacher, num_cls=4, lr=args.lr,
                            augment=True, t_max=epochs,
                            student_model=student, device=device)
        fit(tr, data(module, root), max_epochs=epochs,
            out_dir=f"results/{sk}", resume=not args.force)
        evaluate(sk, tr, t0)


if __name__ == "__main__":
    main()
