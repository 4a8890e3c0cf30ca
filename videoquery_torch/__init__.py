"""videoquery_torch — the PyTorch/CUDA port of ``videoquery``.

It serves the broker round (``python -m videoquery_torch.service.broker``)
and extracts two-stream TSN features from video
(``python -m videoquery_torch.pipeline.extract``) on one NVIDIA GPU, with
the ingest path around it that a host without jax needs: caffemodels to npz
weights (``python -m videoquery_torch.nn.convert_caffe``), decode worker
processes feeding compact uploads to the card (``pipeline/mpstream.py``,
``--workers N --host_gray --host_crop --host_yuv420``), and the CSVs into
``.vqidx`` shards (``python -m videoquery_torch.service.loader ...
--shard_out DIR --no_api``; ``index/persist.py`` loads them). The
similarity pass and the fused query scores run on a hand-written CUDA
kernel (``kernels/csrc/query_kernel.cu``), the TV-L1 flow on two more (one
pyramid level, ``kernels/csrc/tvl1_level.cu``; the window warp,
``kernels/csrc/window_warp.cu``); everything else is host code or plain
PyTorch. The two kernels of the JAX package's tools have their
counterparts too: the fused Inception block
(``kernels/csrc/inception_block.cu``, driven by
``python -m videoquery_torch.tools.inception_block_bench``) and the
dynamic-shift roll (``kernels/csrc/roll.cu``,
``python -m videoquery_torch.tools.roll_repro``). I3D's max pools run on
a sixth and its bf16 stem conv on a seventh, TimeSformer's residual adds
and LayerNorms on an eighth and Video Swin's window attention on a ninth,
which port no Pallas kernel (``kernels/csrc/max_pool3d.cu``,
``kernels/csrc/stem_conv3d.cu``, ``kernels/csrc/add_norm.cu``,
``kernels/csrc/window_attention.cu``). The
JAX package
``videoquery`` is the reference this package is tested against; this
package imports nothing of it and keeps its own copies of the jax-free
modules it needs (``pipeline/sampling.py``, ``pipeline/decode.py``,
``testing/fake_api.py``, ``testing/mp_stubs.py``, ``nn/prototxt.py``, and
``testing/caffe_wire.py``, the caffemodel writer of the JAX package's tests).

Scale-out and training run on ``torch.distributed`` (NCCL between cards,
Gloo on the CPU): ``search/distributed.py::ShardedSearch`` scores each
rank's shard of the index on the same CUDA kernel and gathers only the
[Q, k] candidates; ``pipeline/extract.py::Extractor(mesh=...)`` splits
clip batches over the mesh's "data" axis and each stream's splits over
"model"; ``train/trainer.py::TSNTrainer`` fine-tunes a BN-Inception
stream under ``DistributedDataParallel``, with checkpoints in
``train/checkpoint.py``.

Subpackages mirror ``videoquery``: ``core``, ``index``, ``kernels``, ``nn``,
``pipeline``, ``search``, ``service``, ``testing``, ``train``, and
``tools`` (the tool kernels' A/B and repro tools, the flow-quality gate and the
extraction measurement tools). Their ``__init__`` files name the JAX
twin's package-level names and import each only when it is asked for
(``_lazy.py``), so any module can be imported alone.
"""

__version__ = "0.1.0"
