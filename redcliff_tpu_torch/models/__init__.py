"""Model families of the port (``models/``): REDCLIFF-S and its baselines,
PCMCI and R-PCMCI (host, ``models/pcmci.py``), and the time-series
transformer.

The JAX package's ``models/__init__.py`` exports nothing; the port exports
each ported family's model class and config and the transformer's
classes. PCMCI's functions stay in their module: ``pcmci`` is the name of
both the module and its function, and exporting the function here would
hide the module. Importing this package builds and imports nothing CUDA.
"""
from redcliff_tpu_torch.models.clstm_fm import CLSTMFM, CLSTMFMConfig
from redcliff_tpu_torch.models.cmlp_fm import CMLPFM, CMLPFMConfig
from redcliff_tpu_torch.models.dcsfa_nmf import (DcsfaNmf, DcsfaNmfConfig,
                                                 FullDCSFAModel)
from redcliff_tpu_torch.models.dgcnn import DGCNNConfig, DGCNNModel
from redcliff_tpu_torch.models.dynotears import (DynotearsModel,
                                                 DynotearsVanillaModel)
from redcliff_tpu_torch.models.navar import (NAVAR, NAVARConfig, NAVARLSTM,
                                             NAVARLSTMConfig)
from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                RedcliffSCMLPConfig)
from redcliff_tpu_torch.models.ts_transformer import (
    TSTransformerConfig, TSTransformerEncoder,
    TSTransformerEncoderClassiregressor)

__all__ = [
    "CLSTMFM", "CLSTMFMConfig", "CMLPFM", "CMLPFMConfig",
    "DcsfaNmf", "DcsfaNmfConfig", "FullDCSFAModel",
    "DGCNNConfig", "DGCNNModel", "DynotearsModel", "DynotearsVanillaModel",
    "NAVAR", "NAVARConfig", "NAVARLSTM", "NAVARLSTMConfig",
    "RedcliffSCMLP", "RedcliffSCMLPConfig",
    "TSTransformerConfig", "TSTransformerEncoder",
    "TSTransformerEncoderClassiregressor",
]
