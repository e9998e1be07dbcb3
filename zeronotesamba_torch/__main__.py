from zeronotesamba_torch.cli import main

main()
