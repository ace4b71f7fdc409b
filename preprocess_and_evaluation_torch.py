"""Evaluation prep and metric CLI on the PyTorch port (the flags and ``-f``
modes of ``preprocess_and_evaluation.py``; see ``bbdm_tpu_torch/evaluation/cli.py``).

    python preprocess_and_evaluation_torch.py -f FID -s DIR1 -t DIR2 --weights inception.pth
    python preprocess_and_evaluation_torch.py -f LPIPS -s DATA -t GT -n 5 --weights lpips_alex.pth

The metric networks run on CUDA card 0 and raise where there is none; ``--cpu``
runs them on the CPU.
"""

from bbdm_tpu_torch.evaluation.cli import main

if __name__ == "__main__":
    main()
