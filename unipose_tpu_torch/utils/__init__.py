from unipose_tpu_torch.utils.meters import AverageMeter  # noqa: F401
from unipose_tpu_torch.utils.logger import Logger  # noqa: F401
