from pnpflow_tpu_torch.main import main

# guarded: a data_backend grain worker re-imports this module
if __name__ == "__main__":
    main()
