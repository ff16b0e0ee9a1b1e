"""Every CLI of the port sets strict float32 (TF32 off for cuDNN's
convolutions and for matmuls) through ``core.runtime`` before it builds a
model or a trainer.  The flags are process state that needs no card, so
this runs on the CPU: each CLI's ``main`` is stopped at the precision
call, with both flags turned on beforehand."""
import pytest
import torch

from sim2real_lane_segment_tpu_torch.cli import (basic_control, comparison,
                                                 datagen, distill,
                                                 domain_study, enjoy,
                                                 free_camera, hist_match,
                                                 make_demo_video,
                                                 manual_control,
                                                 postprocess, preprocess_db,
                                                 serve, sim2real_convert,
                                                 sim_benchmark, test, train,
                                                 train_cyclegan,
                                                 train_imitation,
                                                 train_reinforcement)
from sim2real_lane_segment_tpu_torch.core import runtime
from sim2real_lane_segment_tpu_torch.train import cyclegan, supervised
from sim2real_lane_segment_tpu_torch.train import distill as train_distill

CLIS = {
    "train": (train, ["--trainType", "sim", "--dataPath", "x"]),
    "test": (test, ["-t", "baseline", "--checkpointPath", "x"]),
    "serve": (serve, ["--checkpointPath", "x", "--int8"]),
    "train_cyclegan": (train_cyclegan, ["--source_dir", "a",
                                        "--target_dir", "b"]),
    "sim2real_convert": (sim2real_convert, ["--dataPath", "x",
                                            "--modelWeightsPath", "y"]),
    "hist_match": (hist_match, ["--ds_source", "a", "--ds_reference", "b"]),
    "domain_study": (domain_study, ["--workdir", "w"]),
    "distill": (distill, ["--dataPath", "x", "--teacherPath", "y"]),
    "datagen": (datagen, ["--output_dir", "r"]),
    "postprocess": (postprocess, ["-id", "r", "-od", "d"]),
    "preprocess_db": (preprocess_db, ["--dbType", "sim", "--dataPath", "d"]),
    "make_demo_video": (make_demo_video, ["-t", "baseline",
                                          "--checkpointPath", "x",
                                          "--videoIns", "v"]),
    "comparison": (comparison, ["--dataPath", "d", "--baselinePath", "a",
                                "--sandtPath", "b", "--hmPath", "c",
                                "--cycleganPath", "e", "--mmePath", "f"]),
    "basic_control": (basic_control, []),
    "sim_benchmark": (sim_benchmark, []),
    "free_camera": (free_camera, ["--orbit"]),
    "manual_control": (manual_control, []),
    "train_imitation": (train_imitation, []),
    "train_reinforcement": (train_reinforcement, []),
    "enjoy": (enjoy, ["imitation", "--weights", "x"]),
}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_sets_float32_precision_first(name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    real = runtime.set_float32_precision
    calls = []

    def stop():
        real()
        calls.append((torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32))
        raise _Stop

    built = []

    def forbid(what):
        def f(*a, **kw):
            built.append(what)
            raise AssertionError(f"{what} built before the precision call")
        return f

    monkeypatch.setattr(runtime, "set_float32_precision", stop)
    monkeypatch.setattr(test, "build_model", forbid("a model"))
    for cls in (supervised.SupervisedTrainer, cyclegan.CycleGANTrainer,
                train_distill.DistillTrainer):
        monkeypatch.setattr(cls, "__init__", forbid(cls.__name__))
    cli, argv = CLIS[name]
    with pytest.raises(_Stop):
        cli.main(argv)
    assert calls == [(False, False)] and not built
