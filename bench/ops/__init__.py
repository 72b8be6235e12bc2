"""Operations of a traffic mix's cycle, one module each, found by the name
an entry's ``"op"`` gives (``workload.Workload``)."""
