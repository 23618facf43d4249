"""Model registry of the port: the wsinfer-zoo surface the pipeline consumes.

Counterpart of wsinsight_tpu/zoo/__init__.py, with its own copy of the
bundled ``registry.json``. ``ModelHandle.load_state_dict`` replaces
``load_flax_params`` and returns a torch state dict with torchvision names.

Weights resolution order for registered models (the JAX package's):
1. ``WSINSIGHT_MODEL_DIR/<name>.msgpack`` (flax checkpoint, carried across)
2. ``WSINSIGHT_MODEL_DIR/<name>.pt|.pth|.ts`` (torch checkpoint)
3. huggingface_hub download of the upstream TorchScript (when network +
   huggingface_hub are available).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Optional, Sequence

import torch

from ..errors import WsinsightException

_BUNDLED_REGISTRY = Path(__file__).parent / "registry.json"


class ModelNotFoundError(WsinsightException):
    pass


class WeightsNotFoundError(WsinsightException):
    pass


@dataclasses.dataclass
class TransformConfigurationItem:
    name: str
    arguments: Optional[dict] = None


@dataclasses.dataclass
class ObjectDetectionConfiguration:
    name: str | None = None
    normalization_pmin: float = 1.0
    normalization_pmax: float = 99.8


@dataclasses.dataclass
class ModelConfiguration:
    """Model-config JSON contents (wsinfer-zoo schema + WSInsight extensions)."""

    architecture: str
    num_classes: int
    class_names: Sequence[str]
    patch_size_pixels: int
    spacing_um_px: float
    transform: Sequence[TransformConfigurationItem] = dataclasses.field(default_factory=list)
    # WSInsight extensions (reference: cli/infer.py:843-847, cli/patch.py:680-684)
    object_based: bool = False
    mixed_precision: bool = False
    stain_normalization: bool = False
    object_detection: ObjectDetectionConfiguration | None = None
    halo_size_pixels: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfiguration":
        transform = [
            TransformConfigurationItem(name=t["name"], arguments=t.get("arguments"))
            for t in d.get("transform", [])
        ]
        od = d.get("object_detection")
        od_cfg = None
        if od:
            od_cfg = ObjectDetectionConfiguration(
                name=od.get("name"),
                normalization_pmin=od.get("normalization_pmin", 1.0),
                normalization_pmax=od.get("normalization_pmax", 99.8),
            )
        return cls(
            architecture=d["architecture"],
            num_classes=d["num_classes"],
            class_names=list(d["class_names"]),
            patch_size_pixels=d["patch_size_pixels"],
            spacing_um_px=d["spacing_um_px"],
            transform=transform,
            object_based=bool(d.get("object_based", False)),
            mixed_precision=bool(d.get("mixed_precision", False)),
            stain_normalization=bool(d.get("stain_normalization", False)),
            object_detection=od_cfg,
            halo_size_pixels=int(d.get("halo_size_pixels", 0)),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "architecture": self.architecture,
            "num_classes": self.num_classes,
            "class_names": list(self.class_names),
            "patch_size_pixels": self.patch_size_pixels,
            "spacing_um_px": self.spacing_um_px,
            "transform": [
                {"name": t.name, **({"arguments": t.arguments} if t.arguments else {})}
                for t in self.transform
            ],
        }
        if self.object_based:
            d["object_based"] = True
        if self.mixed_precision:
            d["mixed_precision"] = True
        if self.stain_normalization:
            d["stain_normalization"] = True
        if self.halo_size_pixels:
            d["halo_size_pixels"] = self.halo_size_pixels
        if self.object_detection is not None:
            d["object_detection"] = {
                "name": self.object_detection.name,
                "normalization_pmin": self.object_detection.normalization_pmin,
                "normalization_pmax": self.object_detection.normalization_pmax,
            }
        return d


@dataclasses.dataclass
class ModelHandle:
    """A resolvable model: configuration + a way to obtain its weights."""

    name: str
    config: ModelConfiguration
    weights_path: str | None = None  # local flax msgpack or torch checkpoint
    hf_repo_id: str | None = None
    hf_revision: str | None = None

    def load_state_dict(self, model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
        """The weights as a torch state dict (CPU tensors, torchvision names).
        ``model``, the module they are for, tells a flax checkpoint's
        transposed convolutions from its convolutions."""
        from ..models.convert import (
            flax_params_to_state_dict,
            load_flax_msgpack,
            load_torch_weights,
        )

        path = self._resolve_weights()
        if path.suffix in (".msgpack", ".flax"):
            return flax_params_to_state_dict(load_flax_msgpack(path), model)
        sd = load_torch_weights(path)
        if self.config.architecture.lower().replace("-", "_").startswith("hovernet"):
            from ..models.convert import normalize_hovernet_keys

            sd = normalize_hovernet_keys(sd)  # released spellings: 'conv0./.', '<x>/bn.'
        return sd

    def _resolve_weights(self) -> Path:
        if self.weights_path:
            p = Path(self.weights_path)
            if p.exists():
                return p
            raise WeightsNotFoundError(f"weights not found: {p}")
        model_dir = os.getenv("WSINSIGHT_MODEL_DIR")
        if model_dir:
            for suffix in (".msgpack", ".pt", ".pth", ".ts"):
                cand = Path(model_dir) / f"{self.name}{suffix}"
                if cand.exists():
                    return cand
        if self.hf_repo_id:
            try:
                from huggingface_hub import hf_hub_download  # type: ignore

                try:  # prefer the local HF cache; avoids retry storms offline
                    return Path(
                        hf_hub_download(
                            self.hf_repo_id,
                            "torchscript_model.pt",
                            revision=self.hf_revision,
                            local_files_only=True,
                        )
                    )
                except Exception:
                    pass
                return Path(
                    hf_hub_download(
                        self.hf_repo_id, "torchscript_model.pt", revision=self.hf_revision
                    )
                )
            except Exception as err:
                raise WeightsNotFoundError(
                    f"could not obtain weights for '{self.name}': {err}. Place a"
                    f" checkpoint at $WSINSIGHT_MODEL_DIR/{self.name}.pt"
                ) from err
        raise WeightsNotFoundError(f"no weights source for model '{self.name}'")


class Registry:
    def __init__(self, models: dict[str, dict]):
        self._models = models

    @property
    def models(self) -> dict[str, dict]:
        return self._models

    def get_model_by_name(self, name: str) -> ModelHandle:
        if name not in self._models:
            raise ModelNotFoundError(
                f"model '{name}' not found in registry; known models:"
                f" {sorted(self._models)}"
            )
        entry = self._models[name]
        return ModelHandle(
            name=name,
            config=ModelConfiguration.from_dict(entry["config"]),
            hf_repo_id=entry.get("hf_repo_id"),
            hf_revision=entry.get("hf_revision"),
        )


def load_registry(registry_file: Path | str | None = None) -> Registry:
    """Load the model registry, honoring WSINFER_ZOO_REGISTRY_PATH."""
    if registry_file is None:
        env = os.getenv("WSINFER_ZOO_REGISTRY_PATH")
        if env:
            if not Path(env).exists():
                # a typo'd override must not silently run the bundled registry
                raise FileNotFoundError(
                    f"WSINFER_ZOO_REGISTRY_PATH points to a missing file: {env}"
                )
            registry_file = env
        else:
            registry_file = _BUNDLED_REGISTRY
    with open(registry_file) as fh:
        data = json.load(fh)
    return Registry(data["models"])


def get_registered_model(name: str) -> ModelHandle:
    """Registry lookup (reference: modellib/models.py:24-36)."""
    return load_registry().get_model_by_name(name)


def load_local_model(config_path: str | Path, weights_path: str | Path) -> ModelHandle:
    """Local --config/--model-path pair (reference: cli/infer.py:511-528)."""
    with open(config_path) as fh:
        cfg = ModelConfiguration.from_dict(json.load(fh))
    return ModelHandle(name=Path(config_path).stem, config=cfg, weights_path=str(weights_path))


def _init_normal(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    p.copy_(torch.randn(p.shape, generator=gen) * std)


def randomize_weights(model: torch.nn.Module, gen: torch.Generator | int = 0,
                      conv_gain: float = 1.0) -> torch.nn.Module:
    """Seeded random weights for any model, in place, on the CPU: linear
    layers normal with variance 1/fan-in, convolutions ``conv_gain``/fan-in,
    transposed convolutions 1/in-channels; biases N(0, 0.1^2), so a padded
    window's bias-filled tokens differ from zeros; pos_embed, cls and
    register tokens N(0, 0.02^2) (flax's init) and the rel-pos tables
    N(0, 0.1^2), so rel-pos moves the scores; LayerScale gains (DINOv2's
    ``ls1``/``ls2.gamma``) U[0.1, 1], where flax's 1e-5 would leave every
    block near the identity and a bf16 comparison would test little; layer
    and batch norms keep their identity. ``gen`` is a seed or a generator
    that goes on drawing after this. The same seed gives the same weights
    on every host."""
    from ..models.layers import EvalBN

    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            if isinstance(mod, (torch.nn.LayerNorm, EvalBN)):
                continue
            if leaf == "bias":
                _init_normal(p, gen, 0.1)
            elif isinstance(mod, torch.nn.ConvTranspose2d):
                _init_normal(p, gen, (1.0 / p.shape[0]) ** 0.5)
            elif leaf == "weight":
                gain = conv_gain if p.dim() == 4 else 1.0
                _init_normal(p, gen, (gain / p[0].numel()) ** 0.5)
            elif leaf == "gamma":  # LayerScale
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))
            else:  # pos_embed, cls_token, reg_token, rel_pos_h / rel_pos_w
                _init_normal(p, gen, 0.1 if leaf.startswith("rel_pos") else 0.02)
    return model


def randomize_cell_model(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded random weights for a cell model (CellViT, HoVer-Net), in place,
    on the CPU.

    ``randomize_weights`` with convolutions at variance 2/fan-in (HoVer-Net's
    1/fan-in: its residual sums, without working batch norm, grow with each
    unit's variance, and He's 2 takes its decoders' features to the
    hundreds). Then each
    decoder branch's last conv (CellViT's ``decoder0_header[2]``, HoVer-Net's
    ``decoder.{np,hv,tp}.u0.conv``) is scaled to give unit-scale maps on a
    seeded noise batch, run in float32 whatever the model's compute dtype:
    logits that do not saturate keep the model's numerics visible in
    comparisons. CellViT's probe takes the whole maps (halo 0); HoVer-Net's
    runs at the model's own halo, the least it has. The same seed gives the
    same weights on every host."""
    gen = torch.Generator().manual_seed(seed)
    cellvit = hasattr(model, "nuclei_binary_map_decoder")
    randomize_weights(model, gen, conv_gain=2.0 if cellvit else 1.0)
    with torch.no_grad():
        if cellvit:
            heads = {
                "nuclei_binary_map": model.nuclei_binary_map_decoder.decoder0_header[2],
                "hv_map": model.hv_map_decoder.decoder0_header[2],
                "nuclei_type_map": model.nuclei_type_maps_decoder.decoder0_header[2],
            }
            probe_halo = 0  # whole maps
        else:  # HoVer-Net: it refuses halos under its own
            heads = {key: model.decoder[branch].u0.conv for key, branch in (
                ("nuclei_binary_map", "np"), ("hv_map", "hv"), ("nuclei_type_map", "tp"))}
            probe_halo = model.halo_size
        for head in heads.values():
            head.bias.zero_()
        probe = torch.randn((2, model.img_size, model.img_size, 3), generator=gen)
        saved = model.dtype, model.halo_size
        model.dtype, model.halo_size = torch.float32, probe_halo
        try:
            out = model(probe)
        finally:
            model.dtype, model.halo_size = saved
        for key, head in heads.items():
            head.weight.div_(out[key].std().clamp(min=1e-6))
    return model


def make_random_local_model(
    architecture: str,
    num_classes: int,
    out_dir: str | Path,
    *,
    class_names: Sequence[str] | None = None,
    patch_size_pixels: int = 350,
    spacing_um_px: float = 0.25,
    resize_size: int = 224,
    seed: int = 0,
) -> tuple[Path, Path]:
    """Author a local config + random-weight torch checkpoint (tests, smoke
    runs). Returns (config_path, weights_path).

    Classifiers: weights from a ``torch.Generator`` seeded with ``seed``,
    conv kernels normal with variance 2/fan-in, linear 1/fan-in (the scales
    of the flax initializers the JAX package uses); batch norms and biases
    keep their identity init. With identity batch norms the features grow
    with depth, so the head (the last linear layer: ``fc``, VGG16's
    ``classifier.6``, InceptionV4's ``last_linear``) is then scaled to give
    unit-scale logits on a seeded noise batch: probabilities that are not
    saturated keep the model's numerics visible in comparisons.

    Cell architectures (CellViT, HoVer-Net) take the JAX package's cell
    config (256 px unless given, halo 46, ToTensor + Normalize 0.5/0.5,
    ``end2end`` detection) and ``randomize_cell_model``'s weights.
    """
    from ..models import create_model, is_cell_architecture

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if is_cell_architecture(architecture):
        if patch_size_pixels == 350:  # classifier default: use the cell default
            patch_size_pixels = 256
        if patch_size_pixels % 16:
            raise ValueError(
                f"cell architectures need patch_size_pixels divisible by 16"
                f" (ViT patch embed + decoder upsampling), got {patch_size_pixels}"
            )
        transform = [
            TransformConfigurationItem("ToTensor", None),
            TransformConfigurationItem(
                "Normalize", {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}
            ),
        ]
        cell_fields = dict(
            object_based=True,
            object_detection=ObjectDetectionConfiguration(name="end2end"),
            halo_size_pixels=46,
        )
        model = create_model(architecture, num_classes, halo_size=46, img_size=patch_size_pixels)
        randomize_cell_model(model, seed)
    else:
        transform = [
            TransformConfigurationItem("Resize", {"size": resize_size}),
            TransformConfigurationItem("ToTensor", None),
            TransformConfigurationItem(
                "Normalize",
                {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
            ),
        ]
        cell_fields = {}
        model = create_model(architecture, num_classes)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("weight") and p.dim() in (2, 4):
                    fan_in = p[0].numel()
                    gain = 2.0 if p.dim() == 4 else 1.0
                    p.copy_(torch.randn(p.shape, generator=gen) * (gain / fan_in) ** 0.5)
                elif name.endswith("bias"):
                    p.zero_()
            probe = torch.randn((2, 3, resize_size, resize_size), generator=gen)
            head = [m for m in model.modules() if isinstance(m, torch.nn.Linear)][-1]
            head.weight.div_(model(probe).std().clamp(min=1e-6))
    cfg = ModelConfiguration(
        architecture=architecture,
        num_classes=num_classes,
        class_names=list(class_names or [f"class{i}" for i in range(num_classes)]),
        patch_size_pixels=patch_size_pixels,
        spacing_um_px=spacing_um_px,
        transform=transform,
        **cell_fields,
    )
    config_path = out_dir / "config.json"
    weights_path = out_dir / "weights.pt"
    config_path.write_text(json.dumps(cfg.to_dict(), indent=2))
    torch.save(model.state_dict(), weights_path)
    return config_path, weights_path
