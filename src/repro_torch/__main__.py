"""``python -m repro_torch`` — see :mod:`repro_torch.app.cli`."""

from repro_torch.app.cli import main

if __name__ == "__main__":
    main()
