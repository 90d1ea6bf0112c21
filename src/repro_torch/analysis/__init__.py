"""Program-contract analysis of the port's hot-path programs (port of
repro.analysis)."""
