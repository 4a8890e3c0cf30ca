"""TSN fine-tuning: segment-consensus training of a BN-Inception stream.

Port of ``videoquery/train/trainer.py``: temporal-segment consensus (the
segment logits averaged, then cross-entropy — the TSN recipe), SGD with
momentum and weight decay, dropout before fc-action, frozen-BN semantics
(BN is folded into the convs and trains as part of them). Autograd
differentiates the module's cuDNN convs, as the JAX trainer differentiates
XLA's.

Parallelism: data parallel over the mesh's "data" axis. Every rank is
given the global batch and keeps its own rows (``core.transfer.local_rows``);
``DistributedDataParallel`` averages the gradients over the "data" group,
which equals the JAX trainer's global-batch mean because every shard has
the same size (the batch must divide by the world). The dropout mask is
drawn for the global batch from the step's seed and sliced the same way,
so a step's result does not depend on the world size.

On the card a step runs in float32 with TF32 off and cuDNN's deterministic
algorithms, whatever the process's flags say (they are restored after the
step), so a resumed run equals an uninterrupted one bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from videoquery_torch.core.device import resolve_device
from videoquery_torch.core.meshes import DATA_AXIS, data_rank_and_size
from videoquery_torch.core.transfer import local_rows
from videoquery_torch.nn import bn_inception
from videoquery_torch.nn.bn_inception import BNInception, dropout_keep


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_segments: int = 3          # TSN temporal segments per video
    learning_rate: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 5e-4
    dropout_rate: float = 0.8      # deploy prototxt :742
    num_classes: int = bn_inception.NUM_CLASSES


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.SGD:
    """SGD with momentum and weight decay, no dampening, no Nesterov.

    This is the JAX trainer's optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum)). Both take g' = g + wd * p and p <- p - lr * m. optax
    keeps m = g' + momentum * m from a zero trace; torch keeps
    m = momentum * m + g' and starts from m = g' at the first step, which is
    the value optax's zero trace gives, so the two agree from the first step
    on (tests/test_torch_train.py holds two steps against optax)."""
    return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0,
                           nesterov=False)


def segment_consensus_loss(net, frames: torch.Tensor, labels: torch.Tensor,
                           keep: torch.Tensor | None, cfg: TrainConfig
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """TSN loss: logits averaged over the S segments, then cross-entropy.

    frames f32 [B, S, H, W, C] (preprocessed snippets), labels int64 [B],
    keep the dropout mask bool [B * S, 1024] or None. Returns (loss, accuracy),
    the means over B."""
    b, s = frames.shape[:2]
    out = net(frames.reshape((b * s,) + tuple(frames.shape[2:])), True, keep,
              cfg.dropout_rate)
    logits = out["fc-action"].reshape(b, s, -1).mean(dim=1)    # consensus
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


class _CardFlags:
    """float32 without TF32 and deterministic cuDNN for the duration of a
    step; the caller's flags come back in ``restore``."""

    def __init__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                      b.cudnn.deterministic, b.cudnn.benchmark)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        b.cudnn.deterministic, b.cudnn.benchmark = True, False

    def restore(self) -> None:
        b = torch.backends
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = self.saved


class TSNTrainer:
    """One stream's training state: the module, its optimizer, the step.

    params: the JAX package's layout (``bn_inception.init_params``, a
    converted npz, or ``load_train_state(...)["params"]``). mesh: a (data,
    model) DeviceMesh (``core.meshes.make_mesh``); with one, the module is
    wrapped in DistributedDataParallel over the "data" group. device:
    ``core.device.resolve_device`` (cuda:0 unless "cpu" is named); with a
    mesh it must be of the mesh's device type. opt_state / step resume a
    checkpoint: the momentum buffers in the params' layout."""

    def __init__(self, params, cfg: TrainConfig | None = None, mesh=None,
                 device: torch.device | str | None = None, opt_state=None,
                 step: int = 0):
        self.cfg = cfg or TrainConfig()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.module = BNInception(params).to(self.device)
        self.module.requires_grad_(True)
        self._names = list(_param_names(self.module))
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type}, trainer on {self.device}")
            from torch.nn.parallel import DistributedDataParallel

            self.rank, self.world = data_rank_and_size(mesh)
            self.group = mesh.get_group(DATA_AXIS)
            self.net = DistributedDataParallel(
                self.module, process_group=self.group,
                device_ids=[self.device] if self.device.type == "cuda" else None)
        else:
            self.rank, self.world, self.group = 0, 1, None
            self.net = self.module
        self.optimizer = make_optimizer(self.module.parameters(), self.cfg)
        if opt_state is not None:
            for p, (name, leaf) in zip(self.module.parameters(), self._names):
                buf = _from_jax_layout(opt_state[name][leaf], name, leaf)
                self.optimizer.state[p]["momentum_buffer"] = buf.to(self.device)
        self.steps = int(step)

    def step(self, frames, labels, seed: int) -> dict[str, float]:
        """One SGD step on the global batch (numpy or tensor, equal on every
        rank): frames [B, S, H, W, C] float32, labels [B]; B must divide by
        the world size. The dropout mask comes from `seed`. Returns the loss
        and accuracy of the global batch before the update (the mean of the
        ranks' means), equal on every rank."""
        b, s = frames.shape[:2]
        if b % self.world != 0:
            raise ValueError(f"batch of {b} videos not divisible by {self.world} ranks")
        keep = None
        if self.cfg.dropout_rate > 0.0:
            keep = local_rows(dropout_keep(seed, (b * s, bn_inception.EMBED_DIM),
                                           self.cfg.dropout_rate),
                              self.rank, self.world).to(self.device)
        x = torch.as_tensor(local_rows(frames, self.rank, self.world)).to(
            self.device, torch.float32)
        y = torch.as_tensor(local_rows(labels, self.rank, self.world)).to(
            self.device, torch.int64)
        flags = _CardFlags() if self.device.type == "cuda" else None
        try:
            loss, acc = segment_consensus_loss(self.net, x, y, keep, self.cfg)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        finally:
            if flags is not None:
                flags.restore()
        metrics = torch.stack([loss.detach(), acc.detach()])
        if self.group is not None:
            dist.all_reduce(metrics, group=self.group)
            metrics = metrics / self.world
        self.steps += 1
        loss_v, acc_v = metrics.tolist()
        return {"loss": loss_v, "accuracy": acc_v}

    def params(self) -> dict[str, dict[str, np.ndarray]]:
        """The weights in the JAX package's layout (float32 numpy)."""
        return self.module.to_params()

    def opt_state(self) -> dict[str, dict[str, np.ndarray]]:
        """The momentum buffers in the params' layout (zeros before the
        first step)."""
        out: dict[str, dict[str, np.ndarray]] = {}
        for p, (name, leaf) in zip(self.module.parameters(), self._names):
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            buf = torch.zeros_like(p) if buf is None else buf
            out.setdefault(name, {})[leaf] = _to_jax_layout(buf, name, leaf)
        return out


def _param_names(module: BNInception):
    """(JAX layer name, 'w' | 'b') for each of module.parameters(), in order."""
    for key, _p in module.named_parameters():
        group, _, name = key.partition(".")
        if group in ("weights", "biases"):
            yield name.replace("__", "/"), "w" if group == "weights" else "b"
        else:
            yield "fc-action", "w" if key == "fc_w" else "b"


def _to_jax_layout(t: torch.Tensor, name: str, leaf: str) -> np.ndarray:
    """A tensor of a parameter's shape in the module (OIHW convs) as numpy
    in the JAX layout (HWIO)."""
    if leaf == "w" and name != "fc-action":
        t = t.permute(2, 3, 1, 0)
    return t.detach().cpu().numpy().copy()


def _from_jax_layout(a: np.ndarray, name: str, leaf: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    if leaf == "w" and name != "fc-action":
        t = t.permute(3, 2, 0, 1).contiguous()
    return t
