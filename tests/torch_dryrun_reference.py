"""The JAX package's own counts of a tiny train step, for
``test_torch_dryrun.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dryrun_reference.py DATAxMODEL OUT.json

For each case of ``CASES``: the reference's ``make_train_step`` on a
``DATAxMODEL`` mesh, lowered on abstract inputs and compiled; the
per-device bytes of its parameter and moment shardings, and
``launch.hlo_loops.analyze_hlo``'s loop-aware dot FLOPs of the compiled
program. ``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS``.
"""
import json
import math
import sys

import jax

from repro.configs import get_config
from repro.configs.shapes import ShapeSpec
from repro.launch.hlo_loops import analyze_hlo
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step

# name -> (arch, tiny overrides); the shape: seq, batch, micro-batches
CASES = {
    "dense": ("smollm_135m", dict(ot_iters=4)),
    "dense_no_ot": ("smollm_135m", dict(ot_loss_weight=0.0)),
    "moe": ("deepseek_v3_671b", dict(ot_iters=4, n_experts=4)),
}
SEQ, BATCH, MICRO = 16, 16, 2


def shard_bytes(shapes, shardings) -> int:
    """The bytes one device holds of a tree under its shardings."""
    total = 0
    for leaf, sh in zip(jax.tree.leaves(shapes), jax.tree.leaves(shardings)):
        total += math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
    return total


def main(argv) -> int:
    data, model = (int(x) for x in argv[1].split("x"))
    mesh = make_local_mesh(data, model)
    out = {}
    for name, (arch, kw) in CASES.items():
        cfg = get_config(arch).tiny(**kw)
        step, (p_shape, o_shape, in_specs), (p_sh, o_sh, _) = \
            make_train_step(cfg, mesh, ShapeSpec("t", SEQ, BATCH, "train"),
                            micro_batches=MICRO)
        with mesh:
            hlo = step.lower(p_shape, o_shape, in_specs).compile().as_text()
        out[name] = {
            "param_bytes": shard_bytes(p_shape, p_sh),
            "moment_bytes": (shard_bytes(o_shape.m, o_sh.m)
                             + shard_bytes(o_shape.v, o_sh.v)),
            "flops": analyze_hlo(hlo, data * model)["flops_per_device"],
        }
    with open(argv[2], "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
