"""Copied from ``pegasus_tpu/compat_arguments.py``; only the import lines differ (it reads this package's ``TrainConfig``).

Inria-style argparse parameter groups (compat shim).

The reference configures itself through the gaussian-splatting submodule's
``ModelParams / PipelineParams / OptimizationParams`` argparse groups plus
``get_combined_args`` re-reading the model directory's saved ``cfg_args``
(reference: pegasus.py:20,60-63,151-154 — including the sys.argv append
hack).  PEGASUS-TPU's native configuration is ``pegasus_tpu_torch.config``; this
shim exists so reference-style scripts keep working unchanged.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, Namespace


class ParamGroup:
    def __init__(self, parser: ArgumentParser, name: str, fill_none: bool = False):
        group = parser.add_argument_group(name)
        for key, value in vars(self).items():
            shorthand = False
            if key.startswith("_"):
                shorthand = True
                key = key[1:]
            t = type(value)
            value = value if not fill_none else None
            names = [f"--{key}"] + ([f"-{key[0]}"] if shorthand else [])
            if t == bool:
                group.add_argument(*names, default=value, action="store_true")
            else:
                group.add_argument(*names, default=value, type=t)

    def extract(self, args) -> Namespace:
        out = Namespace()
        for k in vars(self):
            key = k[1:] if k.startswith("_") else k
            if hasattr(args, key):
                setattr(out, key, getattr(args, key))
        return out


class ModelParams(ParamGroup):
    def __init__(self, parser, sentinel: bool = False):
        self.sh_degree = 3
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self.data_device = "tpu"
        self.eval = False
        super().__init__(parser, "Loading Parameters", fill_none=sentinel)

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path) if g.source_path else ""
        return g


class PipelineParams(ParamGroup):
    def __init__(self, parser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    def __init__(self, parser):
        from pegasus_tpu_torch.training.trainer import TrainConfig

        c = TrainConfig()
        self.iterations = c.iterations
        self.position_lr_init = c.position_lr_init
        self.position_lr_final = c.position_lr_final
        self.position_lr_delay_mult = c.position_lr_delay_mult
        self.position_lr_max_steps = c.position_lr_max_steps
        self.feature_lr = c.feature_lr
        self.opacity_lr = c.opacity_lr
        self.scaling_lr = c.scaling_lr
        self.rotation_lr = c.rotation_lr
        self.percent_dense = c.percent_dense
        self.lambda_dssim = c.lambda_dssim
        self.densification_interval = c.densification_interval
        self.opacity_reset_interval = c.opacity_reset_interval
        self.densify_from_iter = c.densify_from_iter
        self.densify_until_iter = c.densify_until_iter
        self.densify_grad_threshold = c.densify_grad_threshold
        super().__init__(parser, "Optimization Parameters")


def get_combined_args(parser: ArgumentParser, argv=None):
    """Merge CLI args with the model directory's saved cfg_args (the
    reference consumes this via a sys.argv append, pegasus.py:151-154)."""
    args_cmdline = parser.parse_args(argv)
    cfg_path = os.path.join(args_cmdline.model_path or "", "cfg_args")
    merged = vars(args_cmdline).copy()
    if args_cmdline.model_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfgfile_string = f.read()
        args_cfgfile = eval(  # noqa: S307 — Inria writes Namespace(...) literals
            cfgfile_string, {"Namespace": Namespace}
        )
        for k, v in vars(args_cfgfile).items():
            if v is not None:
                merged.setdefault(k, v)
                if merged.get(k) is None:
                    merged[k] = v
    return Namespace(**merged)
