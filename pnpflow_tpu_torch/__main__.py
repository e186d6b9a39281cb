from pnpflow_tpu_torch.main import main

main()
