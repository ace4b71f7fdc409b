"""LBBDM-f4 256^2 sampling throughput on one CUDA card: the port's ``bench.py``.

    python bench_torch.py        # knobs and output: bbdm_tpu_torch/tools/bench.py
"""

from bbdm_tpu_torch.tools.bench import main

if __name__ == "__main__":
    main()
