"""Fixed Gen1-validation sample indices used by the GWD ranking protocol.

Dataset-index constants from representations/representation_search/
chosen_indexes.py (data values, reproduced for protocol parity; a copy of
the JAX package's ``metrics/chosen_indexes.py``): ``CHOSEN``
is the 100-sample subset (:2-103); the per-representation convergent subsets
(:106-135) select positions into it; ``extract_indexes`` mirrors :147-150.
"""

CHOSEN = [860, 993, 1025, 1037, 1103, 1446, 1487, 1769, 2193, 2216, 2244, 2854, 2961, 3032, 3112, 3233, 3677, 3949, 3959, 4332, 4567, 4893, 4911, 5042, 5053, 5419, 5671, 5887, 6187, 6918, 7232, 7938, 8240, 8245, 8571, 8741, 9096, 9520, 9613, 9632, 9772, 10131, 10142, 10175, 10413, 10425, 10561, 10983, 11477, 11622, 11658, 12049, 12075, 12077, 12166, 12272, 12334, 12568, 12680, 12771, 12897, 13002, 13263, 13390, 14108, 14183, 14650, 14717, 15025, 15099, 15120, 15161, 15696, 15905, 15916, 16109, 16357, 16526, 16874, 16994, 17014, 17395, 17705, 17791, 17909, 18366, 18529, 18588, 18657, 18823, 18942, 19374, 19409, 19565, 19604, 19648, 20138, 20148, 20241, 20249]

CONVERGENT_POSITIONS = {'VoxelGrid': [28, 29, 30, 31, 32, 34, 37, 38, 98, 99], 'EventHistogram': [17, 18, 52, 53, 57, 60, 63, 67, 68, 71, 75, 82, 99], 'TimeSurface': [13], 'EventStack': [4, 7, 13, 20, 25, 32, 40, 44, 47, 50, 52, 55, 56, 58, 59, 66, 75, 78, 79, 80, 83, 84, 92, 98], 'OptimizedRepresentation': [4, 8, 11, 13, 33, 35, 37, 65, 76, 89], 'TORE': [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99]}


def extract_indexes(event_representation_name: str):
    positions = CONVERGENT_POSITIONS[event_representation_name]
    return [CHOSEN[pos] for pos in positions if pos < len(CHOSEN)]
