"""``python -m nimrud_tpu_torch.bench``: see the package's docstring."""

import sys

from nimrud_tpu_torch.bench import main

sys.exit(main())
