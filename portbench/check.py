"""How `correct` is decided: the program's outputs from the window against
the plain reference (`portbench/reference/`), which builds its own scene
from the recipe's arrays and imports nothing of the program.

Render cells: frames drawn from the seed among those the window
finished (the last always among them), at pixels drawn from the seed;
the reference renders the same pixels from the same poses, samples and
seed, and `image_gap` is the largest over the frames of the mean
absolute difference of the gamma-corrected values.

Training cells: the first three steps of the window's own step object,
against three steps of the reference's autograd and Adam from the same
start values, seeds and target recipe. `loss_gap` is the largest
relative gap of a step's loss; `grad_gap` and `change_gap` the largest
over the leaves of the gap between the program's and the reference's
norm of the first gradient (worked out from Adam's first moment after
step 1) and of the parameters' change after three steps, each against
the larger of that leaf's reference norm and the median leaf's. A leaf
whose reference gradient is under a thousandth of the median leaf's is
left out of `change_gap` (it moves by round-off alone under Adam).

The control (`lower`): the reference with its bounce state rounded to
bfloat16, put in the program's place: the next precision below the
float32 the config states.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.reference import builder as RB
from portbench.reference import render as RR
from portbench.reference import scene as RS
from portbench.reference.config import RenderConfig


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def ref_config(config: dict, spp: int, seed: int, width: int,
               height: int) -> RenderConfig:
    return RenderConfig(nsamples=spp, width=width, height=height,
                        max_bounces=config["max_bounces"],
                        shadow_rays=config["shadow_rays"],
                        compat=config["compat"], seed=seed)


def ref_scene(recipe, config: dict, seed: int, device):
    return RS.compile_scene(recipe.build(RB, config, seed), device,
                            leaf_width=config["bvh_leaf_size"])


def pick(n: int, k: int, seed: int) -> list:
    """k indices of range(n) drawn from the seed, the last among them."""
    rs = np.random.default_rng([seed, 1])
    if n <= k:
        return list(range(n))
    rest = rs.choice(n - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n - 1]


def pixels(width: int, height: int, k: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng([seed, 2])
    return np.sort(rs.choice(width * height, size=min(k, width * height),
                             replace=False)).astype(np.int32)


@torch.no_grad()
def render_ref(scene, config, poses, pix, spp, word, width, height, device,
               lower=None, counts=None):
    """The reference's gamma-corrected values [len(poses), n_pix, 3] of
    the pixels `pix` from each pose."""
    cfg = ref_config(config, spp, word, width, height)
    pid = torch.from_numpy(pix).to(device)
    views = [(RR.camera(p, config["camera"]["fov_deg"], width / height,
                        device), pid) for p in poses]
    s = RR.render_views(scene, views, cfg, width, height, spp, word,
                        lower=lower, counts=counts)
    mean = s.cpu().numpy() / np.float32(spp)
    return RR.to_image(mean).reshape(len(poses), pix.shape[0], 3)


def frame_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each frame's mean absolute difference (NaN where either side is)."""
    return np.abs(got - want).reshape(got.shape[0], -1).mean(1)


def image_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest over frames of the mean absolute difference."""
    return float(np.max(frame_gaps(got, want)))


def norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_gaps(prog: dict, ref: dict, scale: dict) -> dict:
    """{leaf: |norm(prog) - norm(ref)| / max(scale[leaf], median scale)}."""
    med = statistics.median(scale.values())
    return {k: abs(norm(prog[k]) - norm(ref[k])) / max(scale[k], med, 1e-30)
            for k in ref}


def train_gaps(prog: dict, ref: dict) -> dict:
    """The three compared numbers of a training cell from each side's
    readings: `losses` [3], `grad1` {leaf: tensor}, `change` {leaf:
    tensor} (params after step 3 less the start)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    gnorm = {k: norm(v) for k, v in ref["grad1"].items()}
    med = statistics.median(gnorm.values())
    moved = [k for k in gnorm if gnorm[k] >= 1e-3 * med]
    grad = max(leaf_gaps(prog["grad1"], ref["grad1"], gnorm).values())
    cnorm = {k: norm(ref["change"][k]) for k in moved}
    change = max(leaf_gaps({k: prog["change"][k] for k in moved},
                           {k: ref["change"][k] for k in moved},
                           cnorm).values())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def compared(values: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passes(values: dict, limits: dict) -> bool:
    return all(np.isfinite(v) and v <= limits[k] for k, v in values.items())
