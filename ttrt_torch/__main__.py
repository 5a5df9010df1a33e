"""``python -m ttrt_torch`` — run the animated demo."""

import sys

from ttrt_torch.app import main

sys.exit(main())
