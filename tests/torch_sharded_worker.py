"""The ranks of tests/test_torch_sharded_step.py: the port's GRPO step and
decode step on DTensors placed by ``launch.shardings``' specs, over a 2×2
gloo mesh or a single-rank host mesh. A module of its own, so that the
spawned ranks import the port and not JAX."""
import traceback

import torch

ARCH = "granite-3-2b"
R, B = 8, 4                    # train rows, decode rows


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _port_steps(payload, mesh):
    """Both steps of the port on DTensors placed on `mesh`; results whole,
    as numpy."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import bridge
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.launch import shardings as sh, specs
    from repro_torch.lora.adapters import stack_adapters
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.sharding import mesh_context
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = reduced(REGISTRY[ARCH], dtype="float32")
    params, lora, batch = payload["params"], payload["lora"], payload["batch"]
    out = {}
    with mesh_context(mesh), implicit_replication():
        pspec = sh.param_specs(cfg, params, mesh)
        lspec = sh.lora_specs(cfg, lora, mesh)
        p_in = sh.distribute(params, pspec, mesh)
        step = make_train_step(cfg, TrainConfig(group_size=2, accum_steps=2))
        new, opt, metrics = step(
            p_in, sh.distribute(lora, lspec, mesh),
            sh.distribute(adamw_init(lora), sh.opt_specs(lspec), mesh),
            sh.distribute(batch, sh.batch_specs(batch, mesh, R), mesh))
        out["lora"] = bridge.to_numpy(sh.gather(new))
        out["m"] = bridge.to_numpy(sh.gather(opt["m"]))
        out["metrics"] = {k: float(_whole(v)) for k, v in metrics.items()}

        ads = stack_adapters(payload["tenants"])
        cache = payload["cache"]
        rest = {"row_ids": payload["ids"], "cur_tokens": payload["cur"]}
        rest = sh.distribute(rest, sh.batch_specs(rest, mesh, B), mesh)
        logits, after = specs.build_decode_step(cfg)(
            p_in,
            sh.distribute(ads, sh.lora_specs(cfg, ads, mesh, batched=True),
                          mesh),
            rest["row_ids"], rest["cur_tokens"],
            sh.distribute(cache, sh.cache_specs(cfg, cache, mesh, B), mesh))
        out["logits"] = _whole(logits).numpy()
        out["cache"] = bridge.to_numpy(sh.gather(after))
    return out


def run_rank(rank, world, store_path, payload, results):
    """One rank: its process group over a file store, the mesh, the steps."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh, make_mesh
        if world == 1:                 # the host mesh starts its own world
            mesh = make_host_mesh("cpu")
        else:
            dist.init_process_group("gloo", rank=rank, world_size=world,
                                    store=dist.FileStore(store_path, world))
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        try:
            results.put((rank, _port_steps(payload, mesh)))
        finally:
            dist.destroy_process_group()
    except Exception:                  # reported to the parent, which fails
        results.put((rank, traceback.format_exc()))
