"""Physical constants of the AKMA unit system (kcal/mol, A, ps, amu)."""
KB = 0.0019872041      # kcal/mol/K
AKMA = 418.4           # kcal/mol/A/amu -> A/ps^2
COULOMB = 332.0637     # kcal mol^-1 A e^-2
