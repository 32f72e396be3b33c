"""Test-only entry of the port (counterpart of experiments/rcnn_test.py;
reference experiments/relation_rcnn/rcnn_test.py): experiments/test.py.

    python -m relation_tpu_torch.experiments.rcnn_test --cfg <yaml> [test flags]
"""

from relation_tpu_torch.experiments.test import main

if __name__ == "__main__":
    main()
