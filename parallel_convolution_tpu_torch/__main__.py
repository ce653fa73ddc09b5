import sys

from parallel_convolution_tpu_torch.cli import main

sys.exit(main())
