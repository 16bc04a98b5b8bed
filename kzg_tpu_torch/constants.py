"""BLS12-381 curve constants and Ethereum Data Sharding protocol parameters.

A copy of the JAX package's constants module, so that this package imports
nothing of it. Derived values (Montgomery parameters, roots of unity) are
computed from first principles with Python integers.
"""

# ---------------------------------------------------------------------------
# BLS12-381 field moduli
# ---------------------------------------------------------------------------

# Scalar field modulus (255 bits), order of G1/G2.
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Base field modulus (381 bits).
P_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# BLS parameter x (negative); r = x^4 - x^2 + 1, p = (x - 1)^2 * r / 3 + x.
BLS_X = -0xD201000000010000

assert R_MOD == BLS_X**4 - BLS_X**2 + 1
assert P_MOD == (BLS_X - 1) ** 2 * R_MOD // 3 + BLS_X

# Curve equation: E/Fp: y^2 = x^3 + 4.
B_COEFF = 4

# Two-adicity of r - 1: r - 1 = 2^32 * odd.
TWO_ADICITY = 32
assert (R_MOD - 1) % (1 << TWO_ADICITY) == 0
assert (R_MOD - 1) % (1 << (TWO_ADICITY + 1)) != 0

# Primitive root (multiplicative generator) of Fr, per the consensus specs.
PRIMITIVE_ROOT_OF_UNITY = 7

# Root of unity of order 2^32; w^(2^k) has order 2^(32-k).
ROOT_OF_UNITY_2_32 = pow(PRIMITIVE_ROOT_OF_UNITY, (R_MOD - 1) >> TWO_ADICITY, R_MOD)


def root_of_unity(order_log2: int) -> int:
    """Primitive 2^order_log2-th root of unity in Fr."""
    assert 0 <= order_log2 <= TWO_ADICITY
    return pow(ROOT_OF_UNITY_2_32, 1 << (TWO_ADICITY - order_log2), R_MOD)


# ---------------------------------------------------------------------------
# Group generators (standard, from the BLS12-381 spec)
# ---------------------------------------------------------------------------

G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GENERATOR_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_GENERATOR_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_GENERATOR_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_GENERATOR_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

assert (G1_GENERATOR_Y**2 - G1_GENERATOR_X**3 - B_COEFF) % P_MOD == 0

# ---------------------------------------------------------------------------
# Limb decomposition: 16-bit little-endian limbs, limb axis first. The
# Montgomery radices are R = 2^256 for Fr and R = 2^384 for Fp, the same as
# the JAX package's, so Montgomery-form values match it limb for limb.
# ---------------------------------------------------------------------------

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FR_LIMBS = 16  # 256 bits >= 255
FP_LIMBS = 24  # 384 bits >= 381

FR_R = (1 << (LIMB_BITS * FR_LIMBS)) % R_MOD  # 2^256 mod r
FR_R2 = FR_R * FR_R % R_MOD
# -r^{-1} mod 2^LIMB_BITS, for radix-2^16 Montgomery reduction.
FR_N0_INV = (-pow(R_MOD, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

FP_R = (1 << (LIMB_BITS * FP_LIMBS)) % P_MOD  # 2^384 mod p
FP_R2 = FP_R * FP_R % P_MOD
FP_N0_INV = (-pow(P_MOD, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

# ---------------------------------------------------------------------------
# Ethereum Data Sharding protocol parameters
# ---------------------------------------------------------------------------

BYTES_PER_FIELD_ELEMENT = 32
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB  # 131072
FIELD_ELEMENTS_PER_EXT_BLOB = 2 * FIELD_ELEMENTS_PER_BLOB  # 8192
FIELD_ELEMENTS_PER_CELL = 64
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * BYTES_PER_FIELD_ELEMENT  # 2048
CELLS_PER_EXT_BLOB = FIELD_ELEMENTS_PER_EXT_BLOB // FIELD_ELEMENTS_PER_CELL  # 128

BYTES_PER_G1 = 48
BYTES_PER_G2 = 96
BYTES_PER_COMMITMENT = BYTES_PER_G1
BYTES_PER_PROOF = BYTES_PER_G1

TRUSTED_SETUP_NUM_G1_POINTS = FIELD_ELEMENTS_PER_BLOB  # 4096
TRUSTED_SETUP_NUM_G2_POINTS = 65

# Fiat-Shamir domain separators: the blob proof challenge, and the batch
# challenges of blob and of cell verification.
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"

# Coset shift of EIP-7594 erasure recovery: the division by the vanishing
# polynomial runs on the coset 7 * <w>, where that polynomial has no zero.
RECOVERY_SHIFT_FACTOR = 7
