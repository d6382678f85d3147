"""The program's worlds, one module a world kind (a configuration's
"world"): each builds the configuration's world through the program's
own set-up code, from the same raw inputs that reference/worlds/ reads."""
