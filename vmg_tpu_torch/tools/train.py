"""Training command line, the counterpart of ``tools/train.py``:

    python -m vmg_tpu_torch.tools.train --config reds_full \\
        [--dataroot-hr DIR --dataroot-lr DIR] [--cache-keys PKL] \\
        [--experiments-root DIR] [--resume] [--batchsize B] [--max-steps N] \\
        [--max-retries R] [--val-lr-root DIR --val-gt-root DIR --val-clips K] \\
        [--device cuda|cpu] [--multihost [--mesh-shape D T]]

``--config`` names one of the JAX package's training configs
(``configs.TRAIN_PRESETS``: reds_full, reds_few_levels, tiny_demo,
demo_overfit; there is no YAML loader on the card).  The loop is the JAX
command line's: the clip dataset and the prefetching loader (packed trees
through the native assembler), ``grad_acc = total_batch // batch_size``
loader draws an update, ``set_epoch`` on the dataset and the sampler every
epoch, a log line and the scalars (loss, lr, grad_norm, it/s) every
``print_freq`` steps, a checkpoint every ``save_checkpoint_freq`` steps
and a last one at the end, validation every ``val_freq`` steps where
``--val-lr-root`` is given.  ``--resume`` restores the latest checkpoint
under ``<experiments_root>/<name>/ckpt`` (parameters, AdamW moments, the
step, the stochastic-depth generator); the data restarts at epoch 0, as
the JAX loop's does.  ``--max-retries``: a step that raises a device
error (out of memory, an accelerator fault) restores the latest
checkpoint, or the host snapshot taken at the start and every 1000 steps,
and goes on; past the retries the error is raised.  Runs on the card
unless ``--device cpu``; without a card it raises.

``--multihost``: data and tensor parallelism over processes
(``parallel/``), one card each.  Each process joins the process group from
the usual environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``; NCCL on the card, gloo with ``--device cpu``); the config's
``mesh_shape`` (d, t) keeps its tensor size t and puts world / t processes
on the data axis.  Each data index loads its share of the global batch
(``batch_size`` is global), the step averages the gradients over the data
group, and with t > 1 the wide weights and their AdamW moments are stored
sharded over the tensor group (``parallel/tp.py``; a checkpoint holds them
whole).  Process 0 alone logs, validates and writes checkpoints.  Two
processes on the CPU:

    MASTER_ADDR=localhost MASTER_PORT=29512 WORLD_SIZE=2 RANK=0 \\
        python -m vmg_tpu_torch.tools.train --config tiny_demo --device cpu --multihost ... &
    MASTER_ADDR=localhost MASTER_PORT=29512 WORLD_SIZE=2 RANK=1 \\
        python -m vmg_tpu_torch.tools.train --config tiny_demo --device cpu --multihost ...
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from vmg_tpu_torch.ckpt.io import (latest_step, load_trainer_state, restore_checkpoint,
                                   save_checkpoint, trainer_state)
from vmg_tpu_torch.configs import TRAIN_PRESETS, ExperimentConfig
from vmg_tpu_torch.data.clip_dataset import create_dataset
from vmg_tpu_torch.data.loader import DeviceFeed, accumulate_batches, create_dataloader
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.parallel import (gather_state, initialize_distributed, make_mesh,
                                    shard_params, shard_state)
from vmg_tpu_torch.train.schedule import main_lr_schedule
from vmg_tpu_torch.train.train_step import make_train_step
from vmg_tpu_torch.utils.collect_env import collect_env
from vmg_tpu_torch.utils.logging_utils import AverageMeter, setup_logger
from vmg_tpu_torch.utils.misc import count_params, set_random_seed
from vmg_tpu_torch.utils.scalars import make_scalar_logger

# what a failed step may raise and the loop recovers from
DEVICE_ERRORS = (torch.OutOfMemoryError, torch.AcceleratorError)
SNAPSHOT_EVERY = 1000


def _host_copy(state):
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_host_copy(v) for v in state]
    return state


def _eval_fn(cfg: ExperimentConfig, device, lr_root: str, gt_root: str, clips: int):
    """The validation callback: PSNR of the first ``num_frames`` frames of
    the first ``clips`` clips, through a whole-frame SlidingEvaluator on
    the master weights in the compute dtype."""
    from vmg_tpu_torch.eval.eval_utils import read_seq_images
    from vmg_tpu_torch.eval.inference import SlidingEvaluator
    from vmg_tpu_torch.eval.metrics import calculate_psnr
    from vmg_tpu_torch.serve import SRServer

    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    T = cfg.network.num_frames

    def eval_fn(model):
        server = SRServer(cfg.network, model.state_dict(), device, dtype, gelu="erf",
                          fast_flow=False)
        ev = SlidingEvaluator(server, scale=cfg.scale, test_num_frames=T, overlapped_mode=0,
                              spatial_wins=None, overlapped_spatial_length=None,
                              dataset_name="val")
        psnrs = []
        for clip in sorted(os.listdir(lr_root))[:clips]:
            lr = read_seq_images(os.path.join(lr_root, clip))
            gt = read_seq_images(os.path.join(gt_root, clip))
            out = ev.evaluate(lr[:T])
            psnrs.append(np.mean([calculate_psnr(out[i], gt[i]) for i in range(out.shape[0])]))
        return {"val_psnr": float(np.mean(psnrs))}

    return eval_fn


def train(cfg: ExperimentConfig, *, resume: bool = False, max_steps: Optional[int] = None,
          max_retries: int = 3, val_lr_root: Optional[str] = None,
          val_gt_root: Optional[str] = None, val_clips: int = 1, device="cuda",
          init_state: Optional[Mapping[str, torch.Tensor]] = None, hooks=()) -> dict:
    """Train ``cfg`` to ``max_steps`` (default ``cfg.train.niter``) updates.
    ``init_state``: start from this state dict instead of the seeded init.
    ``hooks``: ``edit.hooks.Hook`` objects, called after every update with
    (step, the master model, {"loss": loss}).
    Returns the run's record: the step it started at and ended on, per
    update its loss, grad norm and host-clock ms (from handing the batch
    to the step to the loss on the host), the seconds it waited on the
    loader for each batch, the epochs begun, the retries and the
    checkpoint directory (the final state is its latest step)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device visible; pass device='cpu' (--device cpu) "
                           "to train on the CPU")
    exp_root = os.path.join(cfg.path.experiments_root, cfg.name)
    ckpt_dir = os.path.join(exp_root, "ckpt")
    # over a process group: the (data, tensor) mesh; process 0 alone logs
    mesh = make_mesh(cfg.mesh_shape) if dist.is_initialized() else None
    lead = mesh is None or mesh.rank == 0
    logger = setup_logger(f"vmg_tpu_torch.train:{os.path.abspath(exp_root)}", exp_root, "train",
                          tofile=lead)
    scalars = make_scalar_logger(exp_root, cfg.logger.use_tb_logger, enabled=lead)
    try:
        return _train(cfg, dev, ckpt_dir, logger, scalars, resume, max_steps, max_retries,
                      val_lr_root, val_gt_root, val_clips, init_state, hooks, mesh)
    finally:
        if scalars is not None:
            scalars.close()
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def _train(cfg, dev, ckpt_dir, logger, scalars, resume, max_steps, max_retries, val_lr_root,
           val_gt_root, val_clips, init_state, hooks, mesh) -> dict:
    seed = cfg.train.manual_seed
    set_random_seed(seed)
    lr_of = main_lr_schedule(cfg.train)
    logger.info("environment:\n" + "\n".join(f"  {k}: {v}" for k, v in collect_env().items()))
    t0 = time.time()
    model = create_model(cfg.network, is_train=True, device=dev,
                         generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    tp = mesh is not None and mesh.tensor > 1
    if tp:  # the wide weights stored sharded over the tensor group
        shard_params(mesh, model)
    logger.info(f"model init: {count_params(model) / 1e6:.3f}M params "
                f"({time.time() - t0:.1f}s) on {dev}")

    ds = cfg.dataset
    grad_acc = max(1, ds.total_batch // ds.batch_size) if cfg.train.grad_acc else 1
    step_fn = make_train_step(model, cfg.train, grad_acc=grad_acc,
                              frames_mirror=ds.use_mirrors, mesh=mesh)
    lead = mesh is None or mesh.rank == 0

    def save(step):  # process 0 writes; the others wait for the file
        state = trainer_state(model, step_fn, gen)
        if tp:  # whole, as an unsharded trainer saves it
            state = gather_state(mesh, state, model)
        if lead:
            save_checkpoint(ckpt_dir, step, state)
        if mesh is not None:
            dist.barrier()
    gen = torch.Generator(device=dev).manual_seed(seed + 777)
    start_step = 0
    if resume and latest_step(ckpt_dir) is not None:
        start_step = load_trainer_state(_restore(ckpt_dir, None, mesh, model), model, step_fn,
                                        gen)
        logger.info(f"resumed from step {start_step}")

    dataset = create_dataset(ds, cfg.scale)
    loader = create_dataloader(dataset, ds, num_replicas=1 if mesh is None else mesh.data,
                               rank=0 if mesh is None else mesh.data_index,
                               pin_memory=dev.type == "cuda")
    val_hook = None
    if val_lr_root and lead:
        from vmg_tpu_torch.edit.hooks import EvalIterHook

        val_hook = EvalIterHook(_eval_fn(cfg, dev, val_lr_root, val_gt_root, val_clips),
                                interval=cfg.train.val_freq, logger=logger)

    niter = max_steps or cfg.train.niter
    meter = AverageMeter()
    step, epoch = start_step, 0
    rec = {"start_step": start_step, "steps": [], "losses": [], "grad_norms": [],
           "step_ms": [], "data_wait_s": [], "epochs": 0, "retries": 0,
           "grad_acc": grad_acc, "processes": 1 if mesh is None else mesh.data * mesh.tensor,
           "mesh": (1, 1) if mesh is None else (mesh.data, mesh.tensor)}
    t_log = time.time()
    # failure recovery: a host copy to restore from while no checkpoint is newer
    host_snapshot, snapshot_step = _host_copy(trainer_state(model, step_fn, gen)), step
    retries = 0
    while step < niter:
        dataset.set_epoch(epoch)
        loader.sampler.set_epoch(epoch)
        feed = DeviceFeed(accumulate_batches(iter(loader), grad_acc), dev)
        for batch in feed:
            if step >= niter:
                break
            t1 = time.perf_counter()
            try:
                metrics = step_fn(batch, gen)
                loss = float(metrics["loss"])
            except DEVICE_ERRORS as e:
                retries += 1
                rec["retries"] = retries
                logger.warning(f"device error at step {step} (retry {retries}/{max_retries}): "
                               f"{e}")
                if retries > max_retries:
                    raise
                ck = latest_step(ckpt_dir)
                if ck is not None and ck >= snapshot_step:
                    step = load_trainer_state(_restore(ckpt_dir, ck, mesh, model), model,
                                              step_fn, gen)
                    logger.warning(f"restored checkpoint step {ck}")
                else:
                    step = load_trainer_state(host_snapshot, model, step_fn, gen)
                    logger.warning(f"restored host snapshot step {step}")
                continue
            rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
            step += 1
            rec["steps"].append(step)
            rec["losses"].append(loss)
            rec["grad_norms"].append(float(metrics["grad_norm"]))
            meter.update(loss)
            for h in hooks:
                h.after_iter(step, model, {"loss": loss})
            if step % SNAPSHOT_EVERY == 0:
                host_snapshot, snapshot_step = _host_copy(
                    trainer_state(model, step_fn, gen)), step
            if val_hook is not None:
                val_hook.after_iter(step, model, {})
                if val_hook.latest and step % val_hook.interval == 0:
                    scalars.log(step, **val_hook.latest)
            if step % cfg.logger.print_freq == 0 and lead:
                dt = time.time() - t_log
                logger.info(f"step {step}/{niter} epoch {epoch} loss {meter.average():.5f} "
                            f"({cfg.logger.print_freq / dt:.2f} it/s)")
                scalars.log(step, loss=meter.average(), lr=lr_of(step),
                            grad_norm=float(metrics["grad_norm"]),
                            it_per_s=cfg.logger.print_freq / dt)
                meter.reset()
                t_log = time.time()
            if step % cfg.logger.save_checkpoint_freq == 0:
                save(step)
                logger.info(f"checkpoint saved at step {step}")
        rec["data_wait_s"].extend(feed.waits)
        epoch += 1
        rec["epochs"] = epoch
    save(step)
    logger.info(f"final checkpoint at step {step}")
    rec["end_step"] = step
    rec["ckpt_dir"] = ckpt_dir
    return rec


def _restore(ckpt_dir, step, mesh, model):
    """A saved trainer state, as this process's slices where the model is
    tensor-sharded."""
    state = restore_checkpoint(ckpt_dir, step)
    if mesh is not None and mesh.tensor > 1:
        state = shard_state(mesh, state, model)
    return state


def config_from_args(args) -> ExperimentConfig:
    cfg = copy.deepcopy(TRAIN_PRESETS[args.config])
    if args.batchsize:
        cfg.dataset.batch_size = args.batchsize
    for attr, val in (("dataroot_HR", args.dataroot_hr), ("dataroot_LR", args.dataroot_lr),
                      ("cache_keys", args.cache_keys)):
        if val is not None:
            setattr(cfg.dataset, attr, val or None)
    if args.experiments_root:
        cfg.path.experiments_root = args.experiments_root
    if args.mesh_shape:
        cfg.mesh_shape = tuple(args.mesh_shape)
    return cfg


def join_process_group(cfg: ExperimentConfig, device) -> None:
    """``--multihost``: join the process group from the environment (NCCL
    on the card, gloo on the CPU); ``cfg.mesh_shape`` keeps its tensor size
    and its data axis takes the rest of the processes."""
    initialize_distributed("gloo" if torch.device(device).type == "cpu" else "nccl")
    cfg.mesh_shape = (0, cfg.mesh_shape[1])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VMG training")
    p.add_argument("--config", required=True, choices=sorted(TRAIN_PRESETS))
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint of the experiment")
    p.add_argument("--batchsize", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None, help="override niter")
    p.add_argument("--max-retries", type=int, default=3,
                   help="device errors to recover from by restoring the latest checkpoint")
    p.add_argument("--val-lr-root", default=None,
                   help="LR clip tree to validate on every train.val_freq steps")
    p.add_argument("--val-gt-root", default=None)
    p.add_argument("--val-clips", type=int, default=1)
    p.add_argument("--dataroot-hr", default=None, help="override the HR root")
    p.add_argument("--dataroot-lr", default=None, help="override the LR root")
    p.add_argument("--cache-keys", default=None,
                   help="override the clip-key pickle ('' for none: the tree's own keys)")
    p.add_argument("--experiments-root", default=None,
                   help="override the root of the log, scalars and checkpoints")
    p.add_argument("--mesh-shape", type=int, nargs=2, default=None, metavar=("D", "T"),
                   help="override the config's (data, tensor) mesh_shape, e.g. 0 2: tensor "
                        "parallelism over pairs of processes (with --multihost)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="data parallelism over processes: join the process group from the "
                        "environment first (NCCL on the card, gloo on the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.val_lr_root and not args.val_gt_root:
        raise SystemExit("--val-lr-root needs --val-gt-root")
    cfg = config_from_args(args)
    if args.multihost:
        join_process_group(cfg, args.device)
    try:
        train(cfg, resume=args.resume, max_steps=args.max_steps,
              max_retries=args.max_retries, val_lr_root=args.val_lr_root,
              val_gt_root=args.val_gt_root, val_clips=args.val_clips, device=args.device)
    finally:
        if args.multihost:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
