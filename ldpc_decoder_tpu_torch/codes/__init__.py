"""LDPC codes: alist I/O, Tanner-graph tables, QC lifts, the p41 protograph."""
