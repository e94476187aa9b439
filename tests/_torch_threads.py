"""One intra-op thread a test process, set on import by the port's test
files: the suite's pytest-xdist workers share the cores, and torch's
default of a thread a core in each worker oversubscribes them."""

import torch

torch.set_num_threads(1)
