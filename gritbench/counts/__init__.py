"""Operations and bytes of each cell's work, from the configuration's
widths: the yardstick of the rooflines and of ``mfu``."""
