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

    def load_state_dict(self) -> dict[str, torch.Tensor]:
        """The weights as a torch state dict (CPU tensors, torchvision names)."""
        from ..models.convert import (
            flax_params_to_state_dict,
            load_flax_msgpack,
            load_torch_weights,
        )

        path = self._resolve_weights()
        if path.suffix in (".msgpack", ".flax"):
            return flax_params_to_state_dict(load_flax_msgpack(path))
        return load_torch_weights(path)

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

    Weights come from a ``torch.Generator`` seeded with ``seed``: conv
    kernels normal with variance 2/fan-in, linear 1/fan-in (the scales of the
    flax initializers the JAX package uses); batch norms and biases keep
    their identity init. With identity batch norms the features grow with
    depth, so the head is then scaled to give unit-scale logits on a seeded
    noise batch: probabilities that are not saturated keep the model's
    numerics visible in comparisons.
    """
    from ..models import create_model

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = ModelConfiguration(
        architecture=architecture,
        num_classes=num_classes,
        class_names=list(class_names or [f"class{i}" for i in range(num_classes)]),
        patch_size_pixels=patch_size_pixels,
        spacing_um_px=spacing_um_px,
        transform=[
            TransformConfigurationItem("Resize", {"size": resize_size}),
            TransformConfigurationItem("ToTensor", None),
            TransformConfigurationItem(
                "Normalize",
                {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
            ),
        ],
    )
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
        model.fc.weight.div_(model(probe).std().clamp(min=1e-6))
    config_path = out_dir / "config.json"
    weights_path = out_dir / "weights.pt"
    config_path.write_text(json.dumps(cfg.to_dict(), indent=2))
    torch.save(model.state_dict(), weights_path)
    return config_path, weights_path
