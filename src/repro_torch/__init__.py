"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It mirrors ``repro``'s layout so each module's counterpart is found by
path, imports ``torch`` and numpy only, and keeps ``repro``'s artifact
format so indexes move between the two packages.

Layers
------
- ``repro_torch.core``      : compression transforms and pipelines
                              (CenterNorm → PCA, random projections,
                              dimension drops, autoencoders, distance and
                              contrastive learning → int8 / 1-bit
                              quantizers), every Table-2 method.
- ``repro_torch.retrieval`` : exact top-k search over float, fp16, int8 and
                              1-bit storage; R-Precision; ``.npz`` artifacts.
- ``repro_torch.kernels``   : hand-written CUDA C++ kernels for Hopper
                              (``sm_90a``), each beside its plain PyTorch
                              version.
- ``repro_torch.data``      : the deterministic synthetic DPR-like corpus
                              and the per-(arch × shape) batches.
- ``repro_torch.configs``   : every architecture config and its shapes
                              (copies of ``repro.configs``).
- ``repro_torch.models``    : the ParamSpec layers, the recsys models
                              (two-tower, FM, DIN, DCN-v2) and SchNet.
- ``repro_torch.train``     : the functional optimizer library (AdamW, SGD,
                              int8-moment Adam, schedules), the train step
                              and loop (``trainer``), checkpoints that
                              ``repro`` reads and writes (``checkpoint``)
                              and fault tolerance.
- ``repro_torch.tracing``   : spans inside the search paths, recorded while
                              a profiler records, and always-on counters
                              (the kernels' launches among them).

Device contract: entry points take ``device=None``, which means ``"cuda"``;
without a CUDA device they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
