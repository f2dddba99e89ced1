"""tidybench: score-based causal-discovery baselines (the Table-2 stack).

Port of ``redcliff_tpu/tidybench/``: SLARAC, QRBS and LASAR in vectorized
numpy, and SELVAR with a native C++ core (``native/selvar.cpp``, built with
g++ into ``build/host_native/`` at first use), each a copy of the JAX
package's host code. LASAR needs scikit-learn, imported when it runs.

All algorithms take a (T timepoints × N variables) array and return an N×N
score matrix whose (i, j) entry scores the link X_i → X_j, and accept the
common pre/post-processing switches documented in
redcliff_tpu_torch.tidybench.utils.common_pre_post_processing.
"""
from redcliff_tpu_torch.tidybench.lasar import lasar
from redcliff_tpu_torch.tidybench.qrbs import qrbs
from redcliff_tpu_torch.tidybench.selvar import gtcoef, gtstat, selvar, slvar
from redcliff_tpu_torch.tidybench.slarac import slarac

__all__ = ["slarac", "qrbs", "lasar", "selvar", "slvar", "gtcoef", "gtstat"]
