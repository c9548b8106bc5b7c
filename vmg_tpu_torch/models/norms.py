"""LayerNorm over the trailing dim (``vmg_tpu/models/norms.py`` TorchLayerNorm).

torch's own ``nn.LayerNorm`` (eps=1e-5, affine) is the reference's
semantics: for bf16 inputs it computes the statistics and the affine in
float32 and rounds the result to bf16 once, which is what the JAX
module does by casting around its float32 computation.
"""

from torch import nn

TorchLayerNorm = nn.LayerNorm
