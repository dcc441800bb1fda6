"""Batched serving example: prefill once, decode greedily — the code path
the ``prefill_32k`` / ``decode_32k`` dry-run shapes trace at scale (the
PyTorch port's twin of examples/serve_lm.py).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma-9b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:] or
         ["--arch", "glm4-9b", "--requests", "4",
          "--prompt-len", "32", "--gen", "12"])
    sys.exit(0)
