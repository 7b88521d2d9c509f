from unipose_tpu_torch.data import transforms  # noqa: F401
from unipose_tpu_torch.data.loader import PrefetchLoader, get_dataloader  # noqa: F401
from unipose_tpu_torch.data.lsp import LSPDataset  # noqa: F401
from unipose_tpu_torch.data.mpii import MPIIDataset  # noqa: F401
from unipose_tpu_torch.data.penn_action import PennActionDataset  # noqa: F401
from unipose_tpu_torch.data.bbc import BBCDataset  # noqa: F401
