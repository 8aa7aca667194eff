"""The port's benchmark: FedZO rounds of ``repro_torch`` on one card."""
