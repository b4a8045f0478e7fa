"""Plain PyTorch versions of the SSD scan kernel: the chunked-parallel
SSD and the sequential recurrence of the port's model zoo (one source of
truth), as ``repro/kernels/ssd_scan/ref.py`` re-exports them."""
from repro_torch.models.ssm import ssd_chunked as ssd_chunked_ref  # noqa: F401
from repro_torch.models.ssm import ssd_ref as ssd_sequential_ref   # noqa: F401
